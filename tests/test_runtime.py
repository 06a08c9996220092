"""Entry-point infrastructure: the compile cache's location, the device
record every result carries, the benchmark's refusal to measure the
CPU, the state pytree without flax, and the profile reduction."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from euler_tpu.utils import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    return env


def test_cache_dir_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_cache_dir_fixed_inside_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = runtime.compile_cache_dir()
    monkeypatch.chdir(tmp_path)
    assert runtime.compile_cache_dir() == first  # not from the cwd
    assert first == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_device_record_fields():
    rec = runtime.device_record()
    dev = jax.devices()[0]
    assert rec["platform"] == dev.platform == "cpu"
    assert rec["device_kind"] == dev.device_kind
    assert rec["device_count"] == len(jax.devices())
    assert rec["jax_version"] == jax.__version__
    assert "gpu_name_power_limit" not in rec  # only a GPU has a card


def test_bench_refuses_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py"), "--size", "16"],
        capture_output=True, text=True, env=_cpu_env(), cwd=ROOT,
        timeout=300,
    )
    assert out.returncode != 0
    assert "{" not in out.stdout  # no result line
    assert "no GPU" in out.stderr


def test_state_pytree_without_flax():
    from euler_tpu.config import SimConfig
    from euler_tpu.core.state import zeros_state

    st = zeros_state(SimConfig(nx=8, ny=6), np.array([1, 2], np.uint32))
    leaves, tree = jax.tree.flatten(st)
    back = jax.tree.unflatten(tree, leaves)
    assert type(back) is type(st)
    np.testing.assert_array_equal(np.asarray(back.u), np.asarray(st.u))
    st2 = st.replace(frame_count=st.frame_count + 1)
    assert int(st2.frame_count) == 1 and int(st.frame_count) == 0
    with pytest.raises(AttributeError):
        st.u = st.v  # frozen
    # importing the package pulls in neither flax nor orbax
    probe = ("import sys, euler_tpu; print(sorted({m.split('.')[0] "
             "for m in sys.modules} & {'flax', 'orbax'}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=_cpu_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_profile_reduction():
    """tools/profile_step.py: HLO scope map and the event reduction on a
    small recorded set of device events."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_step as P

    hlo = "\n".join([
        '  %fusion.1 = f32[8]{0} fusion(%p), kind=kLoop, calls=%c, '
        'metadata={op_name="jit(f)/marker_pass/add" source_file="x.py"}',
        '  ROOT %while.2 = (f32[8]) while(%t), condition=%c, body=%b, '
        'metadata={op_name="jit(f)/projection/pcg_solve/while"}',
        '  %fusion.3 = f32[8]{0} fusion(%q), kind=kLoop, calls=%d, '
        'metadata={op_name="jit(f)/projection/mg_hierarchy/dot_general"}',
        '  %copy.4 = f32[8]{0} copy(%r)',
    ])
    layer_of = P.scope_map(hlo)
    assert layer_of == {"fusion.1": "marker_pass", "while.2": "pcg_solve",
                        "fusion.3": "mg_hierarchy"}
    events = [("k1", "fusion.1", 0, 100), ("k2", "while.2", 50, 100),
              ("k3", "fusion.3", 300, 50), ("k4", "copy.4", 400, 100)]
    r = P.reduce_events(events, layer_of, frames=2)
    assert r["busy_ns"] == 150 + 50 + 100
    assert r["window_ns"] == 500
    ms = r["layer_ms_per_frame"]
    assert ms["marker_pass"] == pytest.approx(50e-6)
    assert ms["pcg_solve"] == pytest.approx(50e-6)
    assert ms[P.GLUE] == pytest.approx(50e-6)
