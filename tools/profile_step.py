"""Per-layer device-time breakdown of the benchmark frame on the GPU.

    python tools/profile_step.py [--size 1024] [--frames 4] \
        [--logdir chiprun_out/trace] [bench.py options after --]

Runs bench.py's configuration (the converged 1024² dam break by
default), traces a window of frames with jax.profiler, and reduces the
device events (the "/device:GPU:N" planes of the trace) to:

  * wall time per frame, and the device busy and idle shares of the
    traced window (busy = union of the kernel intervals);
  * device time per frame for each layer: the `jax.named_scope` of
    sim.substep and ops.project (marker_pass, sources, grid_stage,
    mg_hierarchy, pcg_solve, projection); device operations under none
    of them are frame glue (the substep scan, selects, copies);
  * the top device operations by time.

A kernel event names its HLO instruction (its `hlo_op` stat); the
instruction's op_name metadata in the compiled HLO carries the scope.
XLA on the GPU runs the frame as CUDA graphs ("command buffers"), and a
traced graph is one event without layers, so take the per-layer
breakdown with them off:

    XLA_FLAGS=--xla_gpu_enable_command_buffer= python tools/profile_step.py

and the production wall time from bench.py, which leaves them on.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# innermost first: pcg_solve and mg_hierarchy sit inside projection
LAYERS = ("mg_hierarchy", "pcg_solve", "marker_pass", "sources",
          "grid_stage", "projection")
GLUE = "frame glue"

_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*?op_name=\"([^\"]*)\""
)


def scope_map(hlo_text: str) -> dict:
    """{HLO instruction name: layer} from compiled HLO text."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        out[m.group(1)] = next((l for l in LAYERS if l in parts), GLUE)
    return out


def reduce_events(events, layer_of: dict, frames: int) -> dict:
    """events: (name, hlo_op, start_ns, duration_ns) of device kernels.

    Returns per-frame device time per layer and per operation (ms), the
    busy time (union of intervals) and the window they span (ns)."""
    per_layer, per_op = {}, {}
    intervals = []
    for name, hlo_op, start, dur in events:
        key = hlo_op or name
        layer = layer_of.get(key, layer_of.get(name, GLUE))
        per_layer[layer] = per_layer.get(layer, 0.0) + dur
        per_op[key] = per_op.get(key, 0.0) + dur
        intervals.append((start, start + dur))
    intervals.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0
    ms = lambda d: {k: v / frames / 1e6 for k, v in d.items()}  # noqa: E731
    return {"layer_ms_per_frame": ms(per_layer),
            "op_ms_per_frame": ms(per_op),
            "busy_ns": busy, "window_ns": window}


def device_events(xplane_path: str):
    """Kernel events of the "/device:GPU" planes, and the line names seen.

    Only the per-stream lines hold kernels; the derived lines of the
    same plane ("XLA Ops", "XLA Modules", ...) repeat them."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    events, lines = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.add(line.name)
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                stats = dict(e.stats)
                events.append((e.name, stats.get("hlo_op"),
                               e.start_ns, e.duration_ns))
    return events, sorted(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--logdir", default="chiprun_out/trace")
    ap.add_argument("--top", type=int, default=25)
    args, bench_argv = ap.parse_known_args(argv)

    import jax

    import bench
    from euler_tpu.core.presets import dam_break
    from euler_tpu.parallel.spatial import to_spatial
    from euler_tpu.sim import step_frame
    from euler_tpu.utils.runtime import (
        gpu_name_power_limit,
        require_gpu,
        setup_compile_cache,
    )

    require_gpu()
    setup_compile_cache()
    bargs = bench.parse_args(["--size", str(args.size),
                              *[a for a in bench_argv if a != "--"]])
    cfg = bench.build_config(bargs)
    scn, state = dam_break(cfg)
    if cfg.marker_layout == "slots":
        state = to_spatial(cfg, state)

    step = jax.jit(lambda scn, st: step_frame(cfg, scn, st))
    compiled = step.lower(scn, state).compile()
    layer_of = scope_map(compiled.as_text())
    for _ in range(max(1, bargs.warmup_frames)):
        state = compiled(scn, state)
    jax.block_until_ready(state)

    shutil.rmtree(args.logdir, ignore_errors=True)
    jax.profiler.start_trace(args.logdir)
    t0 = time.perf_counter()
    for _ in range(args.frames):
        state = compiled(scn, state)
    jax.block_until_ready(state)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()

    paths = glob.glob(os.path.join(args.logdir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise SystemExit(f"no trace under {args.logdir}")
    events, lines = device_events(paths[0])
    if not events:
        raise SystemExit(f"no device kernel events; GPU lines: {lines}")
    r = reduce_events(events, layer_of, args.frames)

    print(f"gpu: {gpu_name_power_limit()}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"device: {jax.devices()[0].device_kind}; {args.size}^2, "
          f"precon {bargs.precon}, {args.frames} traced frames")
    print(f"wall: {wall / args.frames * 1e3:.3f} ms/frame")
    dev = sum(r["layer_ms_per_frame"].values())
    print(f"device kernel time: {dev:.3f} ms/frame; busy share of the "
          f"kernel window {r['busy_ns'] / max(r['window_ns'], 1):.3f}, "
          f"busy share of wall {r['busy_ns'] / 1e9 / wall:.3f}")
    print("\n== layers (ms/frame, share of device time) ==")
    for layer, v in sorted(r["layer_ms_per_frame"].items(),
                           key=lambda kv: -kv[1]):
        print(f"{v:10.3f}  {100 * v / dev:5.1f}%  {layer}")
    print(f"\n== top {args.top} device operations (ms/frame) ==")
    for op, v in sorted(r["op_ms_per_frame"].items(),
                        key=lambda kv: -kv[1])[: args.top]:
        print(f"{v:10.3f}  {layer_of.get(op, GLUE):13s} {op[:90]}")
    print(f"\nGPU trace lines: {lines}; kernel events: {len(events)}")


if __name__ == "__main__":
    main()
