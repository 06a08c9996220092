"""Dump the compiled HLO of the benchmark frame for op attribution.

    python tools/dump_hlo.py --size 1024 > step_hlo.txt

Compiles for JAX's default device (the GPU on the card; add
JAX_PLATFORMS=cpu to inspect the CPU program).  Each optimized-HLO op
carries source metadata, including the layer's `jax.named_scope`; grep
the hot op names from tools/profile_step.py output to see which Python
line produced them.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    args, bench_argv = ap.parse_known_args()

    import jax

    import bench
    from euler_tpu.core.presets import dam_break
    from euler_tpu.parallel.spatial import to_spatial
    from euler_tpu.sim import step_frame

    cfg = bench.build_config(
        bench.parse_args(["--size", str(args.size), *bench_argv]))
    scn, state = dam_break(cfg)
    if cfg.marker_layout == "slots":
        state = to_spatial(cfg, state)  # bench.py's [2, K, Y, X] store
    lowered = jax.jit(step_frame, static_argnums=0).lower(cfg, scn, state)
    print(lowered.compile().as_text())


if __name__ == "__main__":
    main()
