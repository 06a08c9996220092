"""Process set-up shared by the entry points (cli.py, bench.py,
chip_smoke.py, tools/profile_step.py): where compiled programs are
cached, and what a result says about the device it ran on."""

from __future__ import annotations

import os
import subprocess

# <checkout>/.jax_cache: resolved from this file, never from the cwd, so
# every process of one checkout finds the same cache (the directory is
# part of the cache key).  Listed in .gitignore.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the in-checkout CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads it and no
    directory is set here."""
    import jax

    cache = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache)
    # programs that compile in under 2 s are cheaper to rebuild than to
    # read back
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return cache


def gpu_name_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    one line per card.  A card may be set below its maximum power and
    then runs slower under load, so every timing carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """The device a result was measured on, as JAX reports it, plus the
    card's name and power limit on a GPU."""
    import jax

    dev = jax.devices()[0]
    rec = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "jax_version": jax.__version__,
    }
    if dev.platform == "gpu":
        rec["gpu_name_power_limit"] = gpu_name_power_limit()
    return rec


def peak_bytes_in_use(device=None):
    """Peak bytes the program's arrays held on `device` (default: the
    first), or None where the backend keeps no memory statistics."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def require_gpu() -> None:
    """Raise unless JAX's default device is a GPU: device metrics are
    never measured on the CPU under a device metric's name."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default platform is {platform!r}; this entry "
            "point measures the accelerator and does not fall back to the CPU"
        )
