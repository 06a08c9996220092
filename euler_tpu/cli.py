"""Interactive CLI driver.

Usage (same surface as /root/reference/main.c:982-1002):

    python -m euler_tpu [--rainbow] <scenario>

plus extensions: --size YxX, --fps, --frames (headless), --preset,
--converged, checkpoints.

Keys (main.c:961-980): p pause, f single-frame, r re-colorize, q quit.
Fixed 10 FPS pacing (main.c:1034-1038, misc/time.c:17-31).

The renderer is decoupled from the physics: a render thread consumes the
latest gathered frame and writes to the terminal, so the device step loop
never blocks on terminal I/O (BASELINE.json north star).
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
import time


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="euler_tpu", description="Eulerian liquid simulator (JAX)"
    )
    ap.add_argument("scenario", nargs="?", default=None,
                    help="scenario file, or preset:<name> (dam_break, block_obstacles)")
    ap.add_argument("--rainbow", action="store_true")
    ap.add_argument("--size", default=None, help="grid size YxX (default 40x100)")
    ap.add_argument("--frames", type=int, default=0,
                    help="run N frames headless and exit (no terminal UI)")
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument(
        "--converged",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="converged pressure solve (Galerkin MG-PCG, tol_rel 1e-4, "
        "warm start).  Default: on for grids >= 512², where the "
        "reference's fixed 100-iteration budget stops converging "
        "(PERF.md); off (exact reference solver semantics) otherwise",
    )
    ap.add_argument(
        "--sherlock",
        action="store_true",
        help="trap NaNs under jit (the reference's SHERLOCK FP-exception "
        "build option, CMakeLists.txt:14-16)",
    )
    ap.add_argument("--load", default=None, metavar="CKPT",
                    help="resume from a checkpoint .npz (scenario arg ignored)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="checkpoint file to write (with --checkpoint-every)")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="save a checkpoint every N frames (headless runs; "
                    "saves happen on a background thread)")
    args = ap.parse_args(argv)
    if args.checkpoint_every and not args.checkpoint:
        ap.error("--checkpoint-every requires --checkpoint PATH")
    return args


def _build(args):
    from euler_tpu.config import SimConfig

    if args.load:
        from euler_tpu.io.checkpoint import load

        return load(args.load)
    if args.scenario is None:
        print("usage: euler_tpu [flags] <scenario> (or --load CKPT)",
              file=sys.stderr)
        sys.exit(1)

    from euler_tpu.config import SolverConfig

    ny, nx = 40, 100
    if args.size:
        ny, nx = (int(t) for t in args.size.lower().split("x"))
    # Large grids (>= 512²) take the scale path: the slot marker store
    # and the converged solve.  Smaller ones (the reference-scale
    # scenarios) keep exact reference semantics: the global marker
    # layout and the reference's fixed-budget solve.
    large = nx * ny >= 512 * 512
    converged = large if args.converged is None else args.converged
    solver = (
        # warm_start: seed each substep's solve from the previous
        # pressure (same b-anchored tolerance) — matches bench.py
        SolverConfig(preconditioner="mg", tol_rel=1e-4, warm_start=True)
        if converged
        else SolverConfig()
    )
    cfg = SimConfig(
        nx=nx,
        ny=ny,
        rainbow=args.rainbow,
        marker_layout="slots" if large else "global",
        solver=solver,
    )

    if args.scenario.startswith("preset:"):
        from euler_tpu.core import presets

        name = args.scenario.split(":", 1)[1]
        scn, state = getattr(presets, name)(cfg)
    else:
        from euler_tpu.core.scenario import load_scenario

        try:
            scn, state = load_scenario(args.scenario, cfg)
        except OSError:
            print(f"Could not load {args.scenario}!", file=sys.stderr)
            sys.exit(1)
    if cfg.marker_layout == "slots":
        # spatial [2, K, Y, X] slot store: each slot is one [Y, X] plane
        from euler_tpu.parallel.spatial import to_spatial

        state = to_spatial(cfg, state)
    return cfg, scn, state


def run_headless(args):
    import jax

    from euler_tpu.sim import step_frame_jit

    cfg, scn, state = _build(args)

    # periodic async checkpointing: saves run on a worker thread so the
    # device step loop never blocks on disk I/O (jax arrays are
    # immutable, so handing the state pytree across threads is safe)
    saver = None
    pending: "queue.Queue" = queue.Queue()
    if args.checkpoint:
        from euler_tpu.io.checkpoint import save

        def save_loop():
            while True:
                item = pending.get()
                if item is None:
                    return
                save(args.checkpoint, cfg, scn, item)

        saver = threading.Thread(target=save_loop, daemon=True)
        saver.start()

    # host loop with one trailing sync: per-frame dispatches pipeline.
    # compile + execute a warm-up frame outside the timer, DISCARDING its
    # result so --frames N simulates exactly N frames
    jax.block_until_ready(step_frame_jit(cfg, scn, state))
    t0 = time.perf_counter()
    for i in range(args.frames):
        state = step_frame_jit(cfg, scn, state)
        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            pending.put(state)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    if saver is not None:
        pending.put(state)  # final snapshot
        pending.put(None)
        saver.join()
    dropped = int(state.dropped_markers)
    print(
        f"{args.frames} frames ({cfg.nx}x{cfg.ny}) on "
        f"{jax.devices()[0].device_kind} in {dt:.3f}s "
        f"= {args.frames / dt:.1f} frames/s, "
        f"{cfg.nx * cfg.ny * cfg.max_substeps * args.frames / dt:.3g} cell-steps/s"
        + (f", {dropped} markers dropped (slot capacity)" if dropped else "")
    )


def run_interactive(args):
    from euler_tpu.ops.color import colorize
    from euler_tpu.render import terminal as term
    from euler_tpu.render.ansi import draw_frame
    from euler_tpu.render.downsample import draw_frame_downsampled
    from euler_tpu.sim import step_frame_jit

    cfg, scn, state = _build(args)

    window = {}

    def update_window_size(*_sig):
        rows, cols = term.get_window_size()
        window["rows"], window["cols"] = rows, cols
        term.clear_screen_now()

    update_window_size()
    term.set_window_size_handler(update_window_size)

    # async renderer: latest-frame queue, drops stale frames
    frames: "queue.Queue[bytes]" = queue.Queue(maxsize=1)
    stop = threading.Event()

    def render_loop():
        while not stop.is_set():
            try:
                buf = frames.get(timeout=0.1)
            except queue.Empty:
                continue
            term._write(buf)

    rt = threading.Thread(target=render_loop, daemon=True)
    rt.start()

    term.enable_raw_mode()
    term.clear_screen_now()

    paused = False
    temp_unpause = 0
    frame_period = 1.0 / args.fps
    start = time.monotonic()
    try:
        while True:
            c = term.read_key()
            if c == "p":
                paused = not paused
            elif c == "f":
                temp_unpause += 1
            elif c == "r" and cfg.rainbow:
                state = colorize(cfg, scn, state)
            elif c == "q":
                term.clear_screen_now()
                break

            if not paused or temp_unpause > 0:
                state = step_frame_jit(cfg, scn, state)
                if temp_unpause:
                    temp_unpause -= 1

            # pacing before draw, as the reference orders it
            # (main.c:1034-1037), replicating wait_until exactly
            # (misc/time.c:17-31): sleep the remainder of the period
            # measured from the carried start, SKIP sleeping entirely
            # when >= 1 s has already elapsed (the tv_sec == 0 guard),
            # and carry the post-sleep clock as the next start.
            now = time.monotonic()
            elapsed = now - start
            if elapsed < 1.0:
                wait = frame_period - elapsed
                if wait > 0:
                    time.sleep(wait)
                    now = time.monotonic()
            start = now

            # grids larger than the window: pooled on-device gather
            # (render/downsample.py) instead of the reference's clipping
            rows, cols = window["rows"], window["cols"]
            if cfg.ny - 2 > rows or cfg.nx - 2 > cols:
                buf = draw_frame_downsampled(cfg, scn, state, rows, cols)
            else:
                buf = draw_frame(cfg, scn, state, rows, cols)
            try:  # drop the stale frame if the renderer is behind
                frames.put_nowait(buf)
            except queue.Full:
                try:
                    frames.get_nowait()
                except queue.Empty:
                    pass
                frames.put_nowait(buf)
    finally:
        stop.set()
        rt.join(timeout=1.0)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import jax

    from euler_tpu.utils.runtime import setup_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    setup_compile_cache()
    if args.sherlock:
        from euler_tpu.utils.diagnostics import enable_fpmath_asserts

        enable_fpmath_asserts()
    if args.frames:
        run_headless(args)
    else:
        run_interactive(args)


if __name__ == "__main__":
    main()
