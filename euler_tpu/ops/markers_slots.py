"""Cell-slot marker layout: the gather-free marker pipeline.

The reference (and euler_tpu.ops.markers, the exact-parity layout) keeps
markers in one global array and looks everything up with random-access
indexing, one marker at a time.

The slot layout stores markers by home cell, coordinate-major: flat
marker m = (k*Y + y)*X + x holds marker k of cell (y, x), so the [2, M]
marker array views as px/py of shape [K, Y, X] with the grid dims
minor, so every slot plane is a contiguous [Y, X] image.  The first
`marker_count[y, x]` slots of each cell are valid (front-compacted).
Because the CFL limit (0.75 cells/substep, main.c:838) bounds every
per-substep interaction to the 3x3 neighbourhood of the home cell,
every operation becomes a dense stencil op:

  * velocity sampling — the staggered 2x2 interpolation corners of a
    marker inside cell (y, x) lie in the 3x3 window (see
    interp_stencil.interpolate_stencil, which broadcasts over the
    leading K axis);
  * the DDA collision march (main.c:464-537) — all solid-cell probes lie
    in the 3x3 window, served by selects over 9 shifted copies;
  * re-binning — a marker's destination cell is one of the 9 neighbours,
    so refresh becomes 9 shifted insert passes with per-cell prefix-sum
    compaction (the counterpart of refresh_marker_counts, main.c:102-117).

Semantic deviation from the reference, by design: a cell holds at most K
markers (config slots_per_cell); arrivals beyond K are dropped.  The
reference's count is bounded only by its uint8 counter.  K >= 6-8 makes
drops rare in practice (projection keeps the fluid incompressible); the
"global" layout remains available for strict parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from euler_tpu.config import SimConfig
from euler_tpu.core import rng as rng_mod
from euler_tpu.core.state import FluidState, Scenario
from euler_tpu.ops.interp_stencil import interpolate_stencil

_FLT_MAX = np.float32(np.finfo(np.float32).max)

# Re-binning insertion order: own cell first (stayers keep low slots —
# the all-stay steady state maps slot k to slot k), then the 8
# neighbour offsets lexicographically.  The order defines slot
# assignment within a cell.
OFFSETS_OWN_FIRST = [(0, 0)] + [
    (dy, dx)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if (dy, dx) != (0, 0)
]


def slot_views(cfg: SimConfig, state: FluidState):
    """(px [K,Y,X], py [K,Y,X], valid [K,Y,X]) views of the marker store.

    Slot markers have two equivalent storage layouts:
      * flat [2, M] with m = (k*Y + y)*X + x (the single-chip default —
        matches the global layout's pytree shape, so checkpoints and the
        CLI are layout-agnostic);
      * spatial planes [2, K, Y, X] (+ alive [K, Y, X]) — the grid dims
        are real array axes, so the marker store block-shards over a
        ("y", "x") device mesh exactly like the grid fields (the
        scale-out path, euler_tpu.parallel.spatial).
    All slot ops accept either and write back in kind (pack_slots)."""
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    if state.markers.ndim == 4:
        return state.markers[0], state.markers[1], state.alive
    return (
        state.markers[0].reshape(K, Y, X),
        state.markers[1].reshape(K, Y, X),
        state.alive.reshape(K, Y, X),
    )


def pack_slots(state: FluidState, px, py, valid=None):
    """(markers, alive) leaves matching `state`'s storage layout."""
    if state.markers.ndim == 4:
        markers = jnp.stack([px, py], axis=0)
        alive = state.alive if valid is None else valid
    else:
        markers = jnp.stack([px.reshape(-1), py.reshape(-1)], axis=0)
        alive = state.alive if valid is None else valid.reshape(-1)
    return markers, alive


def _shift2(a, dy: int, dx: int, fill=0):
    """out[..., y, x] = a[..., y - dy, x - dx]: the source-cell view for
    arrivals with offset (dy, dx).  Operates on the last two axes."""
    Y, X = a.shape[-2], a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 2) + [
        (max(dy, 0), max(-dy, 0)),
        (max(dx, 0), max(-dx, 0)),
    ]
    p = jnp.pad(a, pad, constant_values=fill)
    return p[..., max(-dy, 0) : max(-dy, 0) + Y, max(-dx, 0) : max(-dx, 0) + X]


def _stack3x3(a, fill=0):
    """S[dy+1][dx+1][y, x] == a[y + dy, x + dx] (fill beyond edges)."""
    return [
        [_shift2(a, -dy, -dx, fill) for dx in (-1, 0, 1)] for dy in (-1, 0, 1)
    ]


def _select3x3(stack, dy, dx):
    """Value of stack at per-slot offsets dy, dx in {-1, 0, 1}; the [Y, X]
    stack entries broadcast against leading axes of dy/dx."""
    out = None
    for a in (-1, 0, 1):
        row = jnp.where(
            dx == -1,
            stack[a + 1][0],
            jnp.where(dx == 0, stack[a + 1][1], stack[a + 1][2]),
        )
        out = row if out is None else jnp.where(dy == a, row, out)
    return out


def velocity_at_slots(cfg: SimConfig, u, v, fluid, px, py):
    """Staggered velocity at per-slot positions (main.c:440-449), via
    stencil interpolation — valid because a marker's interpolation
    corners stay within the 3x3 window of its home cell."""
    inv_h = np.float32(1.0) / np.float32(cfg.side_length)
    vx = interpolate_stencil(cfg, u, fluid, px * inv_h - 1.0, py * inv_h - 0.5, "u")
    vy = interpolate_stencil(cfg, v, fluid, px * inv_h - 0.5, py * inv_h - 1.0, "v")
    return vx, vy


def _time_to(p0, p1, vel):
    nz = jnp.abs(vel) > 0.0
    return jnp.where(nz, (p1 - p0) / jnp.where(nz, vel, 1.0), _FLT_MAX)


def advect_markers_slots(cfg: SimConfig, scn: Scenario, state: FluidState, dt):
    """main.c:464-537 on the slot layout: identical arithmetic to
    euler_tpu.ops.markers.advect_markers, with every solid probe served
    by a 3x3 select instead of a gather."""
    Y, X = cfg.ny, cfg.nx
    h = np.float32(cfg.side_length)
    inv_h = np.float32(1.0) / h

    px, py, valid = slot_views(cfg, state)
    vx, vy = velocity_at_slots(cfg, state.u, state.v, state.fluid, px, py)

    site_x = jnp.arange(X, dtype=jnp.int32)[None, :]
    site_y = jnp.arange(Y, dtype=jnp.int32)[:, None]
    solid9 = _stack3x3(scn.solid, False)

    def solid_at(yy, xx):
        dy = jnp.clip(yy - site_y, -1, 1)
        dx = jnp.clip(xx - site_x, -1, 1)
        return _select3x3(solid9, dy, dx)

    x_idx = jnp.floor(px * inv_h).astype(jnp.int32)
    y_idx = jnp.floor(py * inv_h).astype(jnp.int32)

    x_dir = jnp.where(vx > 0, 1, -1).astype(jnp.int32)
    nx_idx = x_idx + (vx > 0)
    npx = nx_idx.astype(px.dtype) * h
    t_x = _time_to(px, npx, vx)
    x_off = jnp.where(vx < 0, -1, 0).astype(jnp.int32)

    y_dir = jnp.where(vy > 0, 1, -1).astype(jnp.int32)
    ny_idx = y_idx + (vy > 0)
    npy = ny_idx.astype(py.dtype) * h
    t_y = _time_to(py, npy, vy)
    y_off = jnp.where(vy < 0, -1, 0).astype(jnp.int32)

    t_prev = jnp.zeros_like(px)
    t_near = jnp.minimum(t_x, t_y)
    dt_rem = jnp.zeros_like(px) + dt

    def body(_, c):
        (px, py, vx, vy, x_idx, y_idx, nx_idx, ny_idx, npx, npy,
         t_x, t_y, t_prev, t_near, dt_rem) = c
        active = t_near < dt_rem
        horiz = t_x < t_y

        hit_h = active & horiz & solid_at(y_idx, nx_idx + x_off)
        adv_h = active & horiz & ~hit_h
        hit_v = active & ~horiz & solid_at(ny_idx + y_off, x_idx)
        adv_v = active & ~horiz & ~hit_v
        hit = hit_h | hit_v

        px1 = jnp.where(hit, px + t_prev * vx, px)
        py1 = jnp.where(hit, py + t_prev * vy, py)
        dt1 = jnp.where(hit, dt_rem - t_prev, dt_rem)
        vx1 = jnp.where(hit_h, 0.0, vx)
        vy1 = jnp.where(hit_v, 0.0, vy)

        x_idx1 = jnp.where(adv_h, nx_idx, x_idx)
        nx_idx1 = jnp.where(adv_h, nx_idx + x_dir, nx_idx)
        npx1 = jnp.where(adv_h, nx_idx1.astype(px.dtype) * h, npx)
        y_idx1 = jnp.where(adv_v, ny_idx, y_idx)
        ny_idx1 = jnp.where(adv_v, ny_idx + y_dir, ny_idx)
        npy1 = jnp.where(adv_v, ny_idx1.astype(py.dtype) * h, npy)

        t_x1 = jnp.where(active, _time_to(px1, npx1, vx1), t_x)
        t_y1 = jnp.where(active, _time_to(py1, npy1, vy1), t_y)
        t_prev1 = jnp.where(active, jnp.where(hit, 0.0, t_near), t_prev)
        t_near1 = jnp.where(active, jnp.minimum(t_x1, t_y1), t_near)

        return (px1, py1, vx1, vy1, x_idx1, y_idx1, nx_idx1, ny_idx1,
                npx1, npy1, t_x1, t_y1, t_prev1, t_near1, dt1)

    carry = (px, py, vx, vy, x_idx, y_idx, nx_idx, ny_idx, npx, npy,
             t_x, t_y, t_prev, t_near, dt_rem)
    # moderate unroll: full unrolling of the march explodes XLA compile
    # time
    carry = jax.lax.fori_loop(
        0, cfg.marker_march_iters, body, carry, unroll=2
    )
    (px2, py2, vx, vy, _, _, _, _, _, _,
     _, _, t_prev, t_near, dt_rem) = carry

    t = jnp.where(t_near < _FLT_MAX, dt_rem, t_prev)
    new_x = jnp.where(valid, px2 + t * vx, px)
    new_y = jnp.where(valid, py2 + t * vy, py)
    new_markers, _ = pack_slots(state, new_x, new_y)
    return state.replace(markers=new_markers)


def refresh_marker_counts_slots(cfg: SimConfig, scn: Scenario, state: FluidState):
    """Re-bin advected markers into their new home cells, drop markers in
    sink/solid cells, and recount (refresh_marker_counts, main.c:102-117).

    Nine shifted insert passes (one per possible cell offset); within a
    destination cell, arrivals are compacted to the front of the slot
    axis by prefix-sum ranking.  Arrivals beyond K slots are dropped
    (documented capacity deviation)."""
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    inv_h = np.float32(1.0) / np.float32(cfg.side_length)

    px, py, valid = slot_views(cfg, state)

    ncx = jnp.floor(px * inv_h).astype(jnp.int32)
    ncy = jnp.floor(py * inv_h).astype(jnp.int32)
    site_x = jnp.arange(X, dtype=jnp.int32)[None, :]
    site_y = jnp.arange(Y, dtype=jnp.int32)[:, None]
    ody = jnp.clip(ncy - site_y, -1, 1)
    odx = jnp.clip(ncx - site_x, -1, 1)

    dead_cell = scn.sink | scn.solid  # arrivals here are deleted

    # Pass 1 (sequential over the 9 offsets — the running per-cell count
    # orders arrivals): which candidates land, in which destination slot.
    # The own cell (0, 0) is processed FIRST: stayers keep low slots (in
    # the common all-stay case slot k maps to slot k).  Arrivals from the
    # 8 neighbours follow in lexicographic order.
    count = jnp.zeros((Y, X), jnp.int32)
    dropped = jnp.zeros((), jnp.int32)
    per_offset = []
    for dy, dx in OFFSETS_OWN_FIRST:
        # markers held by cell (y-dy, x-dx) that are bound for (y, x)
        src_sel = _shift2(valid & (ody == dy) & (odx == dx), dy, dx)
        src_px = _shift2(px, dy, dx)
        src_py = _shift2(py, dy, dx)
        rank = jnp.cumsum(src_sel.astype(jnp.int32), axis=0) - 1
        dest = count[None] + rank
        ok = src_sel & (dest < K) & ~dead_cell[None]
        # capacity drops (NOT sink/solid deletions — those match the
        # reference, main.c:109-113): arrivals beyond K slots in one cell
        dropped = dropped + jnp.sum(
            src_sel & (dest >= K) & ~dead_cell[None], dtype=jnp.int32
        )
        per_offset.append((ok, dest, src_px, src_py))
        count = count + jnp.sum(ok, axis=0, dtype=jnp.int32)

    # Pass 2: each destination slot's (unique) candidate as pure masked
    # sums over [Y, X] planes — one big multi-output elementwise dataflow
    # XLA fuses into a single pass over the shifted inputs.
    px_slots, py_slots = [], []
    for d in range(K):
        acc_x = jnp.zeros((Y, X), px.dtype)
        acc_y = jnp.zeros((Y, X), py.dtype)
        for ok, dest, src_px, src_py in per_offset:
            sel_d = ok & (dest == d)  # at most one true along the K axis
            acc_x = acc_x + jnp.sum(jnp.where(sel_d, src_px, 0), axis=0)
            acc_y = acc_y + jnp.sum(jnp.where(sel_d, src_py, 0), axis=0)
        px_slots.append(acc_x)
        py_slots.append(acc_y)
    out_px = jnp.stack(px_slots, axis=0)
    out_py = jnp.stack(py_slots, axis=0)
    # insertion is front-compacted: valid slots are exactly d < count
    out_valid = (
        jnp.arange(K, dtype=jnp.int32)[:, None, None] < count[None]
    )

    markers, alive = pack_slots(state, out_px, out_py, out_valid)
    return state.replace(
        markers=markers,
        alive=alive,
        prev_marker_count=state.marker_count,
        marker_count=count,
        alive_count=jnp.sum(count, dtype=jnp.int32),
        dropped_markers=state.dropped_markers + dropped,
    )


def marker_pass_slots(cfg: SimConfig, scn: Scenario, state: FluidState, dt):
    """March + re-bin: advect_markers_slots then
    refresh_marker_counts_slots (the slot-layout marker pass of one
    substep)."""
    state = advect_markers_slots(cfg, scn, state, dt)
    return refresh_marker_counts_slots(cfg, scn, state)


def update_fluid_sources_slots(cfg: SimConfig, scn: Scenario,
                               state: FluidState, active=None):
    """Source emission (main.c:276-298) on the slot layout.

    Identical sequential RNG/cap semantics to the global layout; the
    emitted marker of a source cell lands in that cell's first free slot
    (= index marker_count, since slots are front-compacted).  `active`
    False suppresses all emissions (bitwise no-op on the marker store;
    see update_fluid_sources)."""
    S = scn.num_sources
    max_count = cfg.max_markers
    K = cfg.slots_per_cell
    Y, X = cfg.ny, cfg.nx

    from euler_tpu.ops.color import hsv_basis

    t = (
        np.float32(0.6) / np.float32(cfg.source_color_period)
    ) * state.frame_count.astype(state.r.dtype)
    src = scn.source
    state = state.replace(
        r=jnp.where(src, hsv_basis(t + 2.0), state.r),
        g=jnp.where(src, hsv_basis(t), state.g),
        b=jnp.where(src, hsv_basis(t - 2.0), state.b),
    )

    if S == 0:
        return state

    exhausted = state.source_exhausted | (state.alive_count == max_count - 1)
    ys = scn.source_yx[:, 0]
    xs = scn.source_yx[:, 1]
    counts_at_src = state.marker_count[ys, xs]
    h = np.float32(cfg.side_length)

    def emit_one(carry, inp):
        rng, alive_count, exhausted = carry
        y, x, count, valid = inp
        can = valid & (~exhausted) & (count < cfg.markers_per_cell) & (count < K)
        if active is not None:
            can = can & active
        # gcc evaluates main.c:288's two randf() args right-to-left:
        # Y jitter draws first (verified vs the compiled binary,
        # tests/test_ref_binary.py).
        ry, rng_a = rng_mod.randf32(rng)
        rx, rng_b = rng_mod.randf32(rng_a)
        rng = jnp.where(can, rng_b, rng)
        pos_x = (x.astype(rx.dtype) + rx) * h
        pos_y = (y.astype(ry.dtype) + ry) * h
        alive_count = alive_count + can.astype(jnp.int32)
        exhausted = exhausted | (alive_count == max_count - 1)
        return (rng, alive_count, exhausted), (can, pos_x, pos_y)

    (rng, alive_count, exhausted), (cans, pos_x, pos_y) = jax.lax.scan(
        emit_one,
        (state.rng, state.alive_count, exhausted),
        (ys, xs, counts_at_src, scn.source_valid),
    )

    # slot of the emitted marker: k = count (first free slot, since slots
    # are front-compacted); suppressed emissions scatter out of range and
    # are dropped
    k_slot = jnp.minimum(counts_at_src, K - 1)
    k_slot = jnp.where(cans, k_slot, K)  # dropped
    if state.markers.ndim == 4:
        markers = state.markers.at[0, k_slot, ys, xs].set(pos_x, mode="drop")
        markers = markers.at[1, k_slot, ys, xs].set(pos_y, mode="drop")
        alive = state.alive.at[k_slot, ys, xs].set(True, mode="drop")
    else:
        flat_slot = (k_slot * Y + ys) * X + xs
        markers = state.markers.at[0, flat_slot].set(pos_x, mode="drop")
        markers = markers.at[1, flat_slot].set(pos_y, mode="drop")
        alive = state.alive.at[flat_slot].set(True, mode="drop")
    marker_count = state.marker_count.at[ys, xs].add(
        cans.astype(jnp.int32), mode="drop"
    )
    return state.replace(
        markers=markers,
        alive=alive,
        marker_count=marker_count,
        alive_count=alive_count,
        source_exhausted=exhausted,
        rng=rng,
    )
