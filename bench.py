"""Headline benchmark: cell-steps/s of the 1024² dam break on one GPU.

    python bench.py [--size 1024] [--frames 20] [--batch B] ...

Prints one JSON line: the headline rate ("value", cell-steps/s) beside
its quality fields (post-projection divergence, dropped markers, PCG
iterations per solve), its set-up cost (compile seconds), peak device
memory, and the device it ran on (platform, device_kind, device count,
the card's name and power limit, the JAX version).

The default is the CONVERGED mode: Galerkin MG-PCG to tol_rel 1e-4 with
warm start, on the slot marker store (K = 8) — the headline number and
the solve-quality number are the same run.  --precon jacobi restores the
reference's give-up-at-100-iterations solve (main.c:735-767).

A cell-step is one grid cell advanced by one CFL substep of the full
pipeline (marker advection + counts + extrapolation + grid advection +
gravity + PCG projection).  Each frame runs the reference's full substep
budget (8), so cell-steps = cells * 8 * frames.  vs_baseline measures
against the reference's derived throughput ceiling of ~3.2e5
cell-steps/s (BASELINE.md: 4,000 cells x 8 substeps x 10 FPS,
pacing-bound single thread).

The benchmark measures the accelerator: it exits non-zero, and prints
no result, when JAX's default device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import time

REFERENCE_CELL_STEPS_PER_SEC = 3.2e5  # BASELINE.md derived ceiling


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=20)
    # default warm-up keeps the early-phase dam-break window; the JSON's
    # active_substeps_per_frame field records the real substep
    # occupancy behind the nominal 8-substep cell-steps metric.  Use
    # --warmup-frames 48 for fully-developed flow (all 8 substeps
    # active).
    ap.add_argument("--warmup-frames", type=int, default=4)
    ap.add_argument("--pcg-iters", type=int, default=100)
    ap.add_argument("--layout", default="slots", choices=["slots", "global"])
    ap.add_argument("--precon", default="mg", choices=["jacobi", "mg", "none"])
    ap.add_argument("--tol-rel", type=float, default=None,
                    help="relative stopping tolerance ||r|| <= max(tol, "
                         "tol_rel*||b||); the reference's absolute 1e-6 "
                         "presumes f64 CG and is unreachable in f32 at "
                         "scale (0 restores it).  Default: 1e-4 for mg "
                         "(converged mode), 1e-6 otherwise (f32 floor)")
    ap.add_argument("--warm-start", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="seed each substep's PCG from the previous "
                         "substep's pressure (same stopping tolerance; "
                         "default: on for mg, off otherwise)")
    ap.add_argument("--slots-per-cell", type=int, default=None,
                    help="slot-store depth K (default: the config's 8; "
                         "16 = lossless on every observed workload)")
    ap.add_argument("--rainbow", action="store_true",
                    help="benchmark the rainbow (colour-advecting) pipeline")
    ap.add_argument("--batch", type=int, default=1,
                    help="independent scenario instances, stepped "
                         "round-robin by one compiled per-frame program")
    ap.add_argument("--frames-per-call", type=int, default=4,
                    help="frames chained inside one jitted dispatch")
    args = ap.parse_args(argv)
    if args.tol_rel is None:
        args.tol_rel = 1e-4 if args.precon == "mg" else 1e-6
    if args.warm_start is None:
        args.warm_start = args.precon == "mg"
    return args


def build_config(args):
    from euler_tpu.config import SimConfig, SolverConfig

    slots_kw = ({} if args.slots_per_cell is None
                else {"slots_per_cell": args.slots_per_cell})
    return SimConfig(
        nx=args.size,
        ny=args.size,
        marker_layout=args.layout,
        rainbow=args.rainbow,
        **slots_kw,
        solver=SolverConfig(
            max_iterations=args.pcg_iters,
            tol=1e-6,
            tol_rel=args.tol_rel,
            dtype="float32",
            preconditioner=args.precon,
            # warm start only helps converged solves; the jacobi speed
            # mode is iteration-budget-bound
            warm_start=args.warm_start and args.precon == "mg",
        ),
    )


def measure(args) -> dict:
    """Compile, warm up and time the configured workload; returns the
    benchmark record without the device fields."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from euler_tpu.core.presets import dam_break
    from euler_tpu.ops.project import divergence_rhs
    from euler_tpu.parallel.spatial import to_spatial
    from euler_tpu.sim import step_frame_stats
    from euler_tpu.utils.runtime import peak_bytes_in_use

    cfg = build_config(args)
    fpc = max(args.frames_per_call, 1) if args.batch == 1 else 1
    calls = max(1, args.frames // fpc)
    warm_calls = max(1, args.warmup_frames // fpc)

    def prepare(seed):
        scn, state = dam_break(cfg, seed=seed)
        if args.layout == "slots":
            # spatial [2, K, Y, X] slot store: each slot is one plane
            state = to_spatial(cfg, state)
        return scn, state

    pairs = [prepare(i) for i in range(args.batch)]

    def chain(scn, state):
        stats = []
        for _ in range(fpc):
            state, st = step_frame_stats(cfg, scn, state)
            stats.append(st)
        return state, jax.tree.map(lambda *xs: jnp.stack(xs), *stats)

    t0 = time.perf_counter()
    step = jax.jit(chain).lower(*pairs[0]).compile()
    compile_seconds = time.perf_counter() - t0

    def run(n_calls, states):
        # host loop over one compiled program: calls dispatch
        # asynchronously and pipeline; one sync at the end
        scns = [p[0] for p in pairs]
        stats = []
        t0 = time.perf_counter()
        for _ in range(n_calls):
            outs = [step(scn, st) for scn, st in zip(scns, states)]
            states = [o[0] for o in outs]
            stats.extend(o[1] for o in outs)
        jax.block_until_ready(states)
        return states, stats, time.perf_counter() - t0

    states = [p[1] for p in pairs]
    states, _, _ = run(warm_calls, states)
    states, stats, elapsed = run(calls, states)

    @jax.jit
    def div_inf(state):
        # inf-norm of the fluid-masked velocity divergence after the
        # final projection: the solve fidelity behind the rate
        fluid = state.marker_count > 0
        b = divergence_rhs(cfg, state.u, state.v, fluid,
                           jnp.asarray(1.0, state.u.dtype))
        return jnp.max(jnp.abs(b))

    frames = calls * fpc * args.batch
    value = cfg.nx * cfg.ny * cfg.max_substeps * frames / elapsed
    active = np.concatenate(
        [np.asarray(s["active_substeps"]).reshape(-1) for s in stats])
    iters = np.concatenate(
        [np.asarray(s["pcg_iterations"]).reshape(-1) for s in stats])
    solves = int(active.sum())
    active_mean = float(active.mean())
    return {
        "metric": _metric_name(args),
        "value": value,
        "unit": "cell-steps/s",
        "vs_baseline": value / REFERENCE_CELL_STEPS_PER_SEC,
        "ms_per_frame": 1e3 * elapsed / frames,
        "frames": frames,
        "warmup_frames": warm_calls * fpc,
        "batch": args.batch,
        "precon": args.precon,
        "pcg_iters_budget": args.pcg_iters,
        "tol_rel": args.tol_rel,
        "warm_start": cfg.solver.warm_start,
        "post_projection_div_inf": max(float(div_inf(s)) for s in states),
        # slot-capacity drops over the whole run (the slots layout's
        # documented deviation from main.c:92-97)
        "dropped_markers": sum(int(s.dropped_markers) for s in states),
        "slots_per_cell": cfg.slots_per_cell,
        "max_substeps": cfg.max_substeps,
        "active_substeps_per_frame": active_mean,
        # the headline counts the nominal substep budget; this folds in
        # the real substep occupancy
        "active_cell_steps_per_sec": value * active_mean / cfg.max_substeps,
        "pcg_iterations_per_solve_mean": (
            float(iters.sum()) / solves if solves else 0.0),
        "pcg_iterations_per_solve_max": int(iters.max()),
        "compile_seconds": compile_seconds,
        "peak_bytes_in_use": peak_bytes_in_use(),
    }


def _metric_name(args):
    suffix = f" x{args.batch}" if args.batch > 1 else ""
    if args.rainbow:
        suffix += " rainbow"
    return f"cell-steps/sec/chip at {args.size}^2{suffix}"


def main(argv=None):
    args = parse_args(argv)

    from euler_tpu.utils.runtime import (
        device_record,
        require_gpu,
        setup_compile_cache,
    )

    require_gpu()
    setup_compile_cache()
    record = measure(args)
    print(json.dumps({**record, **device_record()}), flush=True)


if __name__ == "__main__":
    main()
