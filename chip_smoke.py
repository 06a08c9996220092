"""Bring-up check of the simulator on the GPU: the quickest proof that
the system still starts, runs and is right on the card.

    python chip_smoke.py            # one card: phases 1-6
    python chip_smoke.py --chips 4  # four cards: the sharded paths only

One card, in order (the first error ends the run):
  1. device: JAX's default device must be a GPU; prints its kind and
     count, the JAX version, the card's name and power limit, and the
     compile-cache directory;
  2. reference scale through the CLI: `euler_tpu.cli.main` runs 20
     headless frames of every bundled scenario (and weird-edges in
     rainbow); each final state must be finite and hold markers;
  3. byte parity on the card: replays the reference-binary corpus
     (tests/goldens/ref_binary) in its float64 global-layout
     configuration and prints, per scenario and mode, the first frame
     whose rendered bytes differ; any difference by frame 1 fails;
  4. GPU against CPU: one converged frame of the 256² dam break on both
     backends in this process; velocities, marker counts and the
     Galerkin coarse operators must agree (tolerances below);
  5. full width: bench.py's own measurement of its default
     configuration (1024² dam break, converged MG-PCG, K = 8 slot
     store), 1 warm-up frame then 8 timed frames;
  6. largest supported grid: one converged frame at 4096², with the
     compiled program's memory analysis.

Four cards (--chips 4): parallel/spatial.py's ("y", "x")-sharded frame
of the 2048² dam break against the same frames on one card, and
parallel/mesh.py's data-parallel batch of 4 against each instance
stepped alone.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
On any failure the process exits non-zero and prints no such line.
The CPU tier-1 suite rehearses these phases at tiny sizes
(tests/test_chip_smoke.py); tests marked `chip` run them on the card.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SCENARIOS = ("basic", "block", "filter", "waterfall", "weird-edges")
PARITY_DIR = os.path.join(ROOT, "tests", "goldens", "ref_binary")
# pty window the parity corpus was captured under (g_wy=60, g_wx=130)
PARITY_WINDOW = (60, 130)

# Phase 4 tolerances.  Velocities: the solve stops at tol_rel 1e-4 of
# ||b||, and the two backends sum in different orders, so they agree to
# the solve's own accuracy, not bitwise: 5e-4 of max|u|.  Marker counts:
# a marker within rounding of a cell face may land on either side, so
# at most 0.01% of cells may differ.  The Galerkin products run at
# Precision.HIGHEST and sum at most two nonzero terms: bitwise.
VEL_RTOL = 5e-4
COUNT_FRAC = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def converged_config(size: int):
    """The converged mode of cli.py and bench.py at size²."""
    from euler_tpu.config import SimConfig, SolverConfig

    return SimConfig(
        nx=size, ny=size, marker_layout="slots",
        solver=SolverConfig(preconditioner="mg", tol_rel=1e-4,
                            warm_start=True),
    )


def random_edge_level(Y: int, X: int, seed: int = 0):
    """A Galerkin level with random non-integer float32 weights: a
    reduced-precision (TF32) matrix product would round them."""
    import jax.numpy as jnp
    import numpy as np

    from euler_tpu.ops.multigrid import _edge_level

    rng = np.random.default_rng(seed)
    active = rng.random((Y, X)) < 0.8
    f32 = lambda a: jnp.asarray((a * active).astype(np.float32))  # noqa: E731
    return _edge_level(f32(rng.uniform(1.0, 8.0, (Y, X))),
                       f32(-rng.uniform(0.0, 2.0, (Y, X))),
                       f32(-rng.uniform(0.0, 2.0, (Y, X))),
                       jnp.asarray(active))


def check_finite_state(state, what: str) -> None:
    import numpy as np

    for name in ("u", "v"):
        a = np.asarray(getattr(state, name))
        if not np.isfinite(a).all():
            raise AssertionError(f"{what}: non-finite {name}")
    if int(np.asarray(state.marker_count).sum()) <= 0:
        raise AssertionError(f"{what}: no markers left")


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    """Phase 1: the device, the card and the compile cache."""
    import jax

    from euler_tpu.utils.runtime import (
        device_record,
        require_gpu,
        setup_compile_cache,
    )

    require_gpu()
    cache = setup_compile_cache()
    rec = device_record()
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"[1 device] {rec['device_kind']} x{rec['device_count']}, "
        f"jax {jax.__version__}")
    log(f"[1 device] nvidia-smi: {rec['gpu_name_power_limit']}")
    log(f"[1 device] compile cache {cache} ({n_cached} entries)")
    return rec


def phase_cli(scenarios=SCENARIOS, frames: int = 20, size=None) -> None:
    """Phase 2: `euler_tpu.cli.main` headless on the bundled scenarios
    (plus weird-edges in rainbow); the final state comes back through
    the CLI's own --checkpoint."""
    from euler_tpu import cli
    from euler_tpu.io.checkpoint import load

    runs = [([], s) for s in scenarios]
    if "weird-edges" in scenarios:
        runs.append((["--rainbow"], "weird-edges"))
    with tempfile.TemporaryDirectory() as tmp:
        for extra, name in runs:
            ckpt = os.path.join(tmp, "final.npz")
            argv = [*extra, "--frames", str(frames),
                    os.path.join(ROOT, "scenarios", f"{name}.txt"),
                    "--checkpoint", ckpt]
            if size:
                argv += ["--size", size]
            t0 = time.perf_counter()
            cli.main(argv)
            _, _, state = load(ckpt)
            what = f"{name}{' rainbow' if extra else ''}"
            check_finite_state(state, what)
            log(f"[2 cli] {what}: {frames} frames ok, "
                f"{int(state.alive_count)} markers, "
                f"{time.perf_counter() - t0:.1f} s with compile")


def phase_parity(max_frames=None, names=None) -> dict:
    """Phase 3: replay the reference-binary byte corpus in float64;
    returns {(scenario, rainbow): first differing frame or None}."""
    import jax
    import numpy as np

    from euler_tpu.config import SimConfig, SolverConfig
    from euler_tpu.core.scenario import build_scenario
    from euler_tpu.render.ansi import draw_frame
    from euler_tpu.sim import step_frame_jit

    horizons = {}
    with jax.enable_x64(True):
        for path in sorted(glob.glob(os.path.join(PARITY_DIR, "*.npz"))):
            stem = os.path.basename(path)[: -len(".npz")]
            rainbow = stem.endswith("_rainbow")
            name = stem[: -len("_rainbow")] if rainbow else stem
            if names is not None and name not in names:
                continue
            z = np.load(path)
            data, offs = z["raw"].tobytes(), z["raw_offsets"]
            blobs = [data[offs[i]: offs[i + 1]] for i in range(len(offs) - 1)]
            last = len(blobs) - 1
            if max_frames is not None:
                last = min(last, max_frames)
            cfg = SimConfig(
                rainbow=rainbow,
                solver=SolverConfig(dtype="float64", max_iterations=400),
            )
            with open(os.path.join(ROOT, "scenarios", f"{name}.txt"),
                      "rb") as f:
                scn, st = build_scenario(f.read(), cfg)
            first_diff = None
            for frame in range(last + 1):
                if frame:
                    st = step_frame_jit(cfg, scn, st)
                got = draw_frame(cfg, scn, st, *PARITY_WINDOW)
                # captured blobs exclude the leading \x1b[H and the
                # trailing \x1b[?25l
                if got[3:-6] != blobs[frame]:
                    first_diff = frame
                    break
            mode = "rainbow" if rainbow else "mono"
            horizons[(name, rainbow)] = first_diff
            log(f"[3 parity] {name} {mode}: "
                + (f"first differing frame {first_diff}"
                   if first_diff is not None
                   else f"identical through frame {last}"))
    bad = {k: v for k, v in horizons.items() if v is not None and v <= 1}
    if bad:
        raise AssertionError(f"byte parity broken by frame 1: {bad}")
    return horizons


def phase_gpu_vs_cpu(size: int = 256) -> dict:
    """Phase 4: one converged frame on the default device and on the
    CPU; velocities, marker counts and the coarse operators agree."""
    import jax
    import numpy as np

    from euler_tpu.core.presets import dam_break
    from euler_tpu.ops import multigrid as MG
    from euler_tpu.ops.multigrid import build_galerkin_hierarchy
    from euler_tpu.ops.project import pressure_matrix_diag
    from euler_tpu.parallel.spatial import to_spatial
    from euler_tpu.sim import step_frame

    cfg = converged_config(size)
    scn, st = dam_break(cfg)
    st = to_spatial(cfg, st)
    dev, cpu = jax.devices()[0], jax.devices("cpu")[0]
    step = jax.jit(lambda scn, st: step_frame(cfg, scn, st))

    def on(device):
        s, t = jax.device_put((scn, st), device)
        return jax.device_get(step(s, t))

    out_dev, out_cpu = on(dev), on(cpu)
    umax = max(float(np.abs(out_cpu.u).max()),
               float(np.abs(out_cpu.v).max()))
    du = float(np.abs(out_dev.u - out_cpu.u).max())
    dv = float(np.abs(out_dev.v - out_cpu.v).max())
    frac = float((out_dev.marker_count != out_cpu.marker_count).mean())

    @jax.jit
    def hierarchy(solid, fluid):
        a_diag = pressure_matrix_diag(cfg, solid, fluid)
        return [(lv.c, lv.e, lv.n) for lv in build_galerkin_hierarchy(
            a_diag, fluid, np.float32, min_size=cfg.solver.mg_min_size)]

    h = [jax.device_get(hierarchy(*jax.device_put((scn.solid, st.fluid), d)))
         for d in (dev, cpu)]
    coarse_equal = all(
        np.array_equal(a, b)
        for lv_d, lv_c in zip(h[0][1:], h[1][1:]) for a, b in zip(lv_d, lv_c))
    # Mask-built weights are small integers, exact even in TF32.  Random
    # non-integer weights show whether the matrix-product form really
    # runs at full float32 precision: on the device it must equal the
    # reshape-and-sum form bitwise, and its c/e/n must equal the CPU's.
    # inv_c = 1/c is compared across backends only to print it: the
    # GPU's float32 division rounds differently from the CPU's (on the
    # first H100 run, 2,160 of the 16,384 coarse cells of a 256² level
    # differed; c/e/n matched everywhere).
    lv = random_edge_level(size, size)

    def coarsen(fn, device):
        return jax.device_get(jax.jit(fn)(jax.device_put(lv, device)))

    mm_dev = coarsen(MG.coarsen_galerkin, dev)
    rs_dev = coarsen(MG.coarsen_galerkin_reshape, dev)
    rs_cpu = coarsen(MG.coarsen_galerkin_reshape, cpu)
    same = lambda a, b, fs: all(  # noqa: E731
        np.array_equal(getattr(a, f), getattr(b, f)) for f in fs)
    exact_on_device = same(mm_dev, rs_dev, ("c", "e", "n", "inv_c", "lmax"))
    equal_to_cpu = same(mm_dev, rs_cpu, ("c", "e", "n"))
    inv_ulps = float(np.max(np.abs(mm_dev.inv_c - rs_cpu.inv_c)
                            / np.spacing(np.abs(rs_cpu.inv_c))))
    log(f"[4 {dev.platform} vs cpu] {size}^2 converged frame: "
        f"max|du| {du:.3e}, max|dv| {dv:.3e} (limit {VEL_RTOL} * "
        f"{umax:.4g} = {VEL_RTOL * umax:.3e}); marker_count differs in "
        f"{frac:.2e} of cells (limit {COUNT_FRAC}); coarse operators "
        f"({len(h[0]) - 1} levels) bitwise equal: {coarse_equal}")
    log(f"[4 {dev.platform} vs cpu] random-weight coarsening: matrix "
        f"product bitwise equal to reshape-and-sum on {dev.platform}: "
        f"{exact_on_device}; c/e/n bitwise equal to the CPU's: "
        f"{equal_to_cpu}; inv_c differs from the CPU's by at most "
        f"{inv_ulps:.0f} ulp")
    if max(du, dv) > VEL_RTOL * umax:
        raise AssertionError("velocities differ beyond the solve tolerance")
    if frac > COUNT_FRAC:
        raise AssertionError("marker counts differ in too many cells")
    if not coarse_equal:
        raise AssertionError("Galerkin coarse operators differ")
    if not (exact_on_device and equal_to_cpu):
        raise AssertionError("matrix-product coarsening is not exact")
    return {"du": du, "dv": dv, "umax": umax, "count_frac": frac,
            "matmul_exact": exact_on_device and equal_to_cpu,
            "inv_c_ulps": inv_ulps}


def phase_full_width(size: int = 1024, frames: int = 8) -> dict:
    """Phase 5: bench.py's measuring function on its default
    configuration at `size`²."""
    import bench
    from euler_tpu.utils.runtime import device_record

    rec = device_record()
    log(f"[5 full width] device {rec['device_kind']}; card "
        f"{rec.get('gpu_name_power_limit', 'none')}")
    args = bench.parse_args(["--size", str(size), "--frames", str(frames),
                             "--warmup-frames", "1",
                             "--frames-per-call", "1"])
    r = bench.measure(args)
    log(f"[5 full width] {size}^2 {r['precon']} tol_rel {r['tol_rel']}: "
        f"{r['value']:.6g} cell-steps/s, {r['ms_per_frame']:.3f} ms/frame "
        f"over {r['frames']} frames after {r['warmup_frames']} warm-up")
    log(f"[5 full width] active substeps/frame "
        f"{r['active_substeps_per_frame']:.3f}; PCG iterations/solve mean "
        f"{r['pcg_iterations_per_solve_mean']:.2f} max "
        f"{r['pcg_iterations_per_solve_max']} (budget "
        f"{r['pcg_iters_budget']})")
    log(f"[5 full width] post_projection_div_inf "
        f"{r['post_projection_div_inf']:.4g}, dropped_markers "
        f"{r['dropped_markers']}, compile {r['compile_seconds']:.1f} s, "
        f"peak_bytes_in_use {r['peak_bytes_in_use']}")
    if not math.isfinite(r["post_projection_div_inf"]):
        raise AssertionError("non-finite divergence after projection")
    if r["pcg_iterations_per_solve_max"] >= r["pcg_iters_budget"]:
        raise AssertionError("a converged-mode solve hit its iteration "
                             "budget without reaching tol_rel")
    return r


def phase_largest(size: int = 4096) -> None:
    """Phase 6: compile and run one converged frame at size²."""
    import jax

    from euler_tpu.core.presets import dam_break
    from euler_tpu.parallel.spatial import to_spatial
    from euler_tpu.sim import step_frame

    cfg = converged_config(size)
    scn, st = dam_break(cfg)
    st = to_spatial(cfg, st)
    t0 = time.perf_counter()
    compiled = jax.jit(lambda scn, st: step_frame(cfg, scn, st)).lower(
        scn, st).compile()
    compile_s = time.perf_counter() - t0
    log(f"[6 largest] {size}^2 compile {compile_s:.1f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(scn, st))
    first_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(scn, out))
    log(f"[6 largest] {size}^2 converged frame: {first_ms:.3f} ms (first "
        f"execution), {1e3 * (time.perf_counter() - t0):.3f} ms (second)")
    check_finite_state(out, f"{size}^2 frame")


def _compare(a, b, what: str) -> str:
    import numpy as np

    umax = max(float(np.abs(b.u).max()), float(np.abs(b.v).max()), 1e-30)
    d = max(float(np.abs(a.u - b.u).max()), float(np.abs(a.v - b.v).max()))
    frac = float((np.asarray(a.marker_count)
                  != np.asarray(b.marker_count)).mean())
    msg = (f"{what}: max velocity difference {d:.3e} (limit "
           f"{VEL_RTOL * umax:.3e}), marker_count differs in {frac:.2e} "
           f"of cells")
    if d > VEL_RTOL * umax or frac > COUNT_FRAC:
        raise AssertionError(msg)
    return msg


def _timed_frames(step, scn, st, frames: int):
    import jax

    st = jax.block_until_ready(step(scn, st))  # warm-up frame
    t0 = time.perf_counter()
    for _ in range(frames):
        st = step(scn, st)
    st = jax.block_until_ready(st)
    return st, 1e3 * (time.perf_counter() - t0) / frames


def phase_spatial(size: int = 2048, frames: int = 3, n: int = 4) -> None:
    """Four cards: the ("y", "x")-sharded frame against one card."""
    import jax

    from euler_tpu.core.presets import dam_break
    from euler_tpu.parallel.spatial import (
        make_spatial_step, shard_spatial, spatial_mesh, to_spatial,
    )
    from euler_tpu.sim import step_frame

    cfg = converged_config(size)
    scn, st = dam_break(cfg)
    st = to_spatial(cfg, st)
    mesh = spatial_mesh(n)
    s_scn, s_st = shard_spatial(cfg, mesh, scn, st)
    s_out, s_ms = _timed_frames(make_spatial_step(cfg, mesh), s_scn, s_st,
                                frames)
    devs = s_out.u.sharding.device_set
    if len(devs) != n or len(s_out.markers.sharding.device_set) != n:
        raise AssertionError(f"sharded state sits on {len(devs)} devices")
    one = jax.jit(lambda scn, st: step_frame(cfg, scn, st))
    o_scn, o_st = jax.device_put((scn, st), jax.devices()[0])
    o_out, o_ms = _timed_frames(one, o_scn, o_st, frames)
    msg = _compare(jax.device_get(s_out), jax.device_get(o_out),
                   f"{size}^2 after {frames + 1} frames, mesh "
                   f"{dict(mesh.shape)}")
    log(f"[spatial] {msg}")
    log(f"[spatial] {size}^2 converged: {s_ms:.3f} ms/frame on {n} "
        f"devices ({len(devs)} in the output sharding), {o_ms:.3f} "
        f"ms/frame on one")


def phase_data_parallel(n: int = 4, frames: int = 3) -> None:
    """Four cards: a data-parallel batch of n scenarios on a ("data",)
    mesh against each instance stepped alone."""
    import jax

    from euler_tpu.config import SimConfig
    from euler_tpu.core.scenario import build_scenario
    from euler_tpu.parallel.batch import build_batch
    from euler_tpu.parallel.mesh import make_mesh, make_sharded_step, shard_batch
    from euler_tpu.sim import step_frame_jit

    cfg = SimConfig()
    texts = []
    for i in range(n):
        with open(os.path.join(ROOT, "scenarios",
                               f"{SCENARIOS[i % len(SCENARIOS)]}.txt"),
                  "rb") as f:
            texts.append(f.read())
    mesh = make_mesh(n, data=n)
    scn, st = shard_batch(mesh, *build_batch(texts, cfg))
    b_out, b_ms = _timed_frames(make_sharded_step(cfg, mesh), scn, st,
                                frames)
    if len(b_out.u.sharding.device_set) != n:
        raise AssertionError("batch does not span the mesh")
    b_host = jax.device_get(b_out)
    for i, text in enumerate(texts):
        s1, t1 = build_scenario(text, cfg)
        for _ in range(frames + 1):
            t1 = step_frame_jit(cfg, s1, t1)
        one = jax.tree.map(lambda a: a[i], b_host)
        msg = _compare(one, jax.device_get(t1),
                       f"instance {i} ({SCENARIOS[i % len(SCENARIOS)]})")
        log(f"[data parallel] {msg}")
    log(f"[data parallel] batch of {n} on mesh {dict(mesh.shape)}: "
        f"{b_ms:.3f} ms/frame")


# ------------------------------------------------------------ entry point


def last_line() -> str:
    """The final JSON line, with the device as JAX reports it."""
    import jax

    dev = jax.devices()[0]
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}})


def phases_for(chips: int):
    """The phase functions a run on `chips` cards executes, in order."""
    if chips == 4:
        return [phase_device, phase_spatial, phase_data_parallel]
    return [phase_device, phase_cli, phase_parity, phase_gpu_vs_cpu,
            phase_full_width, phase_largest]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card paths on four cards")
    args = ap.parse_args(argv)
    # phase 4 compares against the CPU backend, so keep it available
    # when the environment names only the GPU
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    phases = phases_for(args.chips)
    if args.chips == 4 and len(jax.devices()) < 4:
        raise SystemExit(f"--chips 4 needs 4 devices, have "
                         f"{len(jax.devices())}")
    t0 = time.perf_counter()
    for phase in phases:
        t = time.perf_counter()
        phase()
        log(f"-- {phase.__name__} done in {time.perf_counter() - t:.1f} s")
    log(f"all phases done in {time.perf_counter() - t0:.1f} s")
    print(last_line(), flush=True)


if __name__ == "__main__":
    main()
