# Build layer — the counterpart of the reference's CMakeLists.txt
# (single target + OVERDRIVE/SHERLOCK options) for a JAX package whose
# only ahead-of-time artifact is the native ANSI encoder.

PY ?= python
CXX ?= g++
# OVERDRIVE (reference CMakeLists.txt:10-12): native-arch optimisation
# for the host-side encoder.  SHERLOCK (CMakeLists.txt:14-16) is a
# runtime flag here: `python -m euler_tpu --sherlock` traps NaNs.
OVERDRIVE ?= 1
CXXFLAGS := -O2 -shared -fPIC $(if $(filter 1,$(OVERDRIVE)),-march=native,)

NATIVE := euler_tpu/native/_encoder.so

.PHONY: all native test bench clean

all: native

native: $(NATIVE)

$(NATIVE): euler_tpu/native/encoder.cpp
	$(CXX) $(CXXFLAGS) -o $@ $<

# Tier-1 suite on the CPU (8 virtual devices, see tests/conftest.py);
# tests marked `chip` skip here and run on the GPU via chip_smoke.py.
test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m 'not slow' -p xdist -n 6 --dist loadfile -p no:randomly

bench:
	$(PY) bench.py

clean:
	rm -f $(NATIVE)
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
