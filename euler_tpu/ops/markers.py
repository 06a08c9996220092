"""Marker-particle tracking: counts, advection with solid collision,
and source emission.

Reference pieces:
  * refresh_marker_counts (/root/reference/main.c:102-117): bin markers
    to cells, delete those in sink/solid cells, keep previous counts.
  * advect_markers (main.c:464-537): per-particle DDA march across cell
    faces, zeroing a velocity component on hitting a solid face.
  * update_fluid_sources (main.c:276-298): sequential emission of at most
    one marker per source cell per substep, capped globally, consuming
    the shared xorshift64* stream in y-major cell order.

Data-parallel reformulations:
  * markers live in a fixed-capacity [M, 2] array with an alive mask
    instead of the reference's swap-remove compaction (main.c:109-115);
    per-cell counts (the observable) are order-independent.
  * the DDA while-loop becomes a fixed number of masked iterations over
    all particles at once; with cfl <= 0.75 the march terminates within
    a handful of iterations (see SimConfig.marker_march_iters).
  * emission is a lax.scan over the static source-cell list, reproducing
    the serial append/cap/RNG semantics; freed slots are reused so the
    capacity behaviour matches the compacting reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from euler_tpu.config import SimConfig
from euler_tpu.core import rng as rng_mod
from euler_tpu.core.state import FluidState, Scenario
from euler_tpu.ops.interp import interpolate_u, interpolate_v

_FLT_MAX = np.float32(np.finfo(np.float32).max)


def marker_cells(cfg: SimConfig, markers):
    """floor(position / h) per marker (main.c:106-107).

    markers is coordinate-major [2, M] (see FluidState.markers)."""
    inv_h = np.float32(1.0) / np.float32(cfg.side_length)
    xi = jnp.floor(markers[0] * inv_h).astype(jnp.int32)
    yi = jnp.floor(markers[1] * inv_h).astype(jnp.int32)
    return yi, xi


def _swap_remove_compact(markers, live_in, doomed):
    """The reference's deletion compaction (main.c:109-115): a doomed
    slot i is overwritten by the LAST live marker (`g_markers[i--] =
    g_markers[--len]`, retrying while the tail marker is itself doomed).
    Net permutation: survivors below the new length stay in place;
    doomed head slots are filled by tail survivors in DECREASING index
    order.  Keeping this exact order matters because advect_markers'
    dt-carry chain (see its docstring) is marker-order-dependent.

    live_in must be a prefix mask (markers [2, M]); returns
    (markers', alive', n')."""
    M = live_in.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    doomed = doomed & live_in
    surv = live_in & ~doomed
    n2 = jnp.sum(surv, dtype=jnp.int32)
    head = idx < n2
    dh = doomed & head                    # doomed head slots, increasing
    ts = surv & ~head                     # tail survivors
    dh_idx = jnp.nonzero(dh, size=M, fill_value=M)[0].astype(jnp.int32)
    # tail survivors in DECREASING index order, aligned with dh_idx
    ts_desc = (M - 1) - jnp.nonzero(
        jnp.flip(ts), size=M, fill_value=-1
    )[0].astype(jnp.int32)
    moved = jnp.take(markers, jnp.clip(ts_desc, 0, M - 1), axis=1)
    markers = markers.at[:, dh_idx].set(moved, mode="drop")
    return markers, head, n2


def refresh_marker_counts(cfg: SimConfig, scn: Scenario, state: FluidState):
    """main.c:102-117: scatter-add histogram + exact swap-remove
    compaction (the array keeps the reference's marker order)."""
    yi, xi = marker_cells(cfg, state.markers)
    yi = jnp.clip(yi, 0, cfg.ny - 1)
    xi = jnp.clip(xi, 0, cfg.nx - 1)
    doomed = scn.sink[yi, xi] | scn.solid[yi, xi]
    surv = state.alive & ~doomed
    counts = jnp.zeros((cfg.ny, cfg.nx), jnp.int32).at[yi, xi].add(
        surv.astype(jnp.int32), mode="drop"
    )
    markers, alive, n2 = _swap_remove_compact(
        state.markers, state.alive, doomed
    )
    return state.replace(
        markers=markers,
        prev_marker_count=state.marker_count,
        marker_count=counts,
        alive=alive,
        alive_count=n2,
    )


def velocity_at(cfg: SimConfig, u, v, fluid, px, py):
    """Staggered velocity sample at world positions (main.c:440-449)."""
    inv_h = np.float32(1.0) / np.float32(cfg.side_length)
    vx = interpolate_u(cfg, u, fluid, px * inv_h - 1.0, py * inv_h - 0.5)
    vy = interpolate_v(cfg, v, fluid, px * inv_h - 0.5, py * inv_h - 1.0)
    return vx, vy


def _time_to(p0, p1, vel):
    """main.c:451-457: (p1 - p0) / v, FLT_MAX for zero velocity."""
    nz = jnp.abs(vel) > 0.0
    return jnp.where(nz, (p1 - p0) / jnp.where(nz, vel, 1.0), _FLT_MAX)


def advect_markers(cfg: SimConfig, scn: Scenario, state: FluidState, dt):
    """main.c:464-537 vectorised over all marker slots.

    The reference's data-dependent while-loop runs while the next face
    crossing is within the remaining dt; every particle here executes
    `marker_march_iters` masked iterations instead (inactive lanes carry
    their state through unchanged), which is exactly equivalent provided
    the true trip count never exceeds the bound — guaranteed by the CFL
    limit on |v|*dt.

    dt-carry (marker_dt_carry, default on = reference semantics): the
    reference mutates its dt PARAMETER on collisions (`dt -= t_prev`,
    main.c:501/513) and the marker loop reuses the mutated value, so a
    collision after a boundary crossing (t_prev > 0) shortens every
    LATER marker's advection in the same call.  Root-caused 2026-08-17
    as the filter frame-29 byte-divergence (the drift survived a strict
    -fno-fast-math -ffp-contract=off reference build, so it was never
    fast-math).  Vectorised as a fixpoint: march all markers with a
    per-marker dt estimate, propagate each marker's post-march dt to
    all later markers (last-changed-wins segment fill), repeat until
    the dt vector is bitwise stable — dt-changing events are rare
    (first at ~frame 26 on filter), so this converges in
    1 + #events passes and costs exactly one march when no event fires.
    """
    if not cfg.marker_dt_carry:
        new_markers, _ = _march_markers(cfg, scn, state, dt)
        return state.replace(markers=new_markers)

    M = state.markers.shape[1]
    f = state.markers.dtype
    dt = jnp.asarray(dt, f)
    idx = jnp.arange(M, dtype=jnp.int32)

    def propagate(dt_vec, dt_out):
        # dead lanes are identity links in the chain
        dt_out = jnp.where(state.alive, dt_out, dt_vec)
        changed = dt_out != dt_vec
        j = jnp.where(changed, idx, -1)
        last = jax.lax.associative_scan(jnp.maximum, j)
        last_excl = jnp.concatenate(
            [jnp.full((1,), -1, last.dtype), last[:-1]]
        )
        picked = jnp.take(dt_out, jnp.clip(last_excl, 0, M - 1))
        return jnp.where(last_excl >= 0, picked, dt)

    def cond(c):
        it, dt_vec, dt_prev, _ = c
        return (it == 0) | ((it < 16) & jnp.any(dt_vec != dt_prev))

    def body(c):
        it, dt_vec, _, markers = c
        new_markers, dt_out = _march_markers(cfg, scn, state, dt_vec)
        return it + 1, propagate(dt_vec, dt_out), dt_vec, new_markers

    _, _, _, new_markers = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), jnp.zeros((M,), f) + dt, jnp.zeros((M,), f),
         state.markers),
    )
    return state.replace(markers=new_markers)


def _march_markers(cfg: SimConfig, scn: Scenario, state: FluidState, dt):
    """One vectorised DDA march pass; dt may be per-marker.  Returns
    (markers', dt_rem) where dt_rem is each marker's remaining-dt
    variable after its collision decrements (the value the reference's
    next marker would observe)."""
    h = np.float32(cfg.side_length)
    solid = scn.solid

    px = state.markers[0]
    py = state.markers[1]
    vx, vy = velocity_at(cfg, state.u, state.v, state.fluid, px, py)

    inv_h = np.float32(1.0) / h
    x_idx = jnp.floor(px * inv_h).astype(jnp.int32)
    y_idx = jnp.floor(py * inv_h).astype(jnp.int32)

    # next horizontal intersect (main.c:473-481)
    x_dir = jnp.where(vx > 0, 1, -1).astype(jnp.int32)
    nx_idx = x_idx + (vx > 0)
    npx = nx_idx.astype(px.dtype) * h
    t_x = _time_to(px, npx, vx)
    x_off = jnp.where(vx < 0, -1, 0).astype(jnp.int32)

    # next vertical intersect (main.c:483-491)
    y_dir = jnp.where(vy > 0, 1, -1).astype(jnp.int32)
    ny_idx = y_idx + (vy > 0)
    npy = ny_idx.astype(py.dtype) * h
    t_y = _time_to(py, npy, vy)
    y_off = jnp.where(vy < 0, -1, 0).astype(jnp.int32)

    t_prev = jnp.zeros_like(px)
    t_near = jnp.minimum(t_x, t_y)
    dt_rem = jnp.zeros_like(px) + dt

    def gather_solid(yy, xx):
        yy = jnp.clip(yy, 0, cfg.ny - 1)
        xx = jnp.clip(xx, 0, cfg.nx - 1)
        return solid[yy, xx]

    def body(_, c):
        (px, py, vx, vy, x_idx, y_idx, nx_idx, ny_idx, npx, npy,
         t_x, t_y, t_prev, t_near, dt_rem) = c
        active = t_near < dt_rem
        horiz = t_x < t_y

        hit_h = active & horiz & gather_solid(y_idx, nx_idx + x_off)
        adv_h = active & horiz & ~hit_h
        hit_v = active & ~horiz & gather_solid(ny_idx + y_off, x_idx)
        adv_v = active & ~horiz & ~hit_v
        hit = hit_h | hit_v

        # hit: advance to the last crossing, zero the component
        # (main.c:498-505, 515-521)
        px1 = jnp.where(hit, px + t_prev * vx, px)
        py1 = jnp.where(hit, py + t_prev * vy, py)
        dt1 = jnp.where(hit, dt_rem - t_prev, dt_rem)
        vx1 = jnp.where(hit_h, 0.0, vx)
        vy1 = jnp.where(hit_v, 0.0, vy)

        # crossing: step to the next face (main.c:507-511, 523-528)
        x_idx1 = jnp.where(adv_h, nx_idx, x_idx)
        nx_idx1 = jnp.where(adv_h, nx_idx + x_dir, nx_idx)
        npx1 = jnp.where(adv_h, nx_idx1.astype(px.dtype) * h, npx)
        y_idx1 = jnp.where(adv_v, ny_idx, y_idx)
        ny_idx1 = jnp.where(adv_v, ny_idx + y_dir, ny_idx)
        npy1 = jnp.where(adv_v, ny_idx1.astype(py.dtype) * h, npy)

        # recompute both times; for untouched lanes this reproduces the
        # stored value bit-for-bit (same inputs), and a zeroed component
        # yields FLT_MAX exactly as the reference sets it.
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
    (px, py, vx, vy, _, _, _, _, _, _,
     _, _, t_prev, t_near, dt_rem) = carry

    # main.c:534-535
    t = jnp.where(t_near < _FLT_MAX, dt_rem, t_prev)
    new_x = px + t * vx
    new_y = py + t * vy
    new_markers = jnp.stack(
        [
            jnp.where(state.alive, new_x, state.markers[0]),
            jnp.where(state.alive, new_y, state.markers[1]),
        ],
        axis=0,
    )
    return new_markers, dt_rem


def get_marker_ops(cfg: SimConfig):
    """(advect, refresh, sources) for the configured marker layout."""
    if cfg.marker_layout == "slots":
        from euler_tpu.ops import markers_slots as ms

        return (
            ms.advect_markers_slots,
            ms.refresh_marker_counts_slots,
            ms.update_fluid_sources_slots,
        )
    return advect_markers, refresh_marker_counts, update_fluid_sources


def get_marker_pass(cfg: SimConfig):
    """One function for the whole march + re-bin stage of a substep."""
    if cfg.marker_layout == "slots":
        from euler_tpu.ops import markers_slots as ms

        return ms.marker_pass_slots

    def _pass(cfg, scn, state, dt):
        state = advect_markers(cfg, scn, state, dt)
        return refresh_marker_counts(cfg, scn, state)

    return _pass


def update_fluid_sources(cfg: SimConfig, scn: Scenario, state: FluidState,
                         active=None):
    """main.c:276-298.

    Emission is sequential in y-major cell order because each append
    consumes the shared RNG stream and the global capacity check is
    order-dependent; the scan is over the (static, small) source list.
    Source-cell colours are refreshed every substep regardless of
    emission (main.c:292-294).

    `active` (traced bool) suppresses ALL emissions when False — used by
    the masked substep loop so an inactive substep is a bitwise no-op on
    the marker store without a whole-array select.
    """
    S = scn.num_sources
    max_count = cfg.max_markers

    # Source-cell colours are refreshed unconditionally (main.c:292-294),
    # with the same phase t for every source cell.
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

    # entry capacity check (main.c:281)
    exhausted = state.source_exhausted | (state.alive_count == max_count - 1)

    ys = scn.source_yx[:, 0]
    xs = scn.source_yx[:, 1]
    counts_at_src = state.marker_count[ys, xs]

    h = np.float32(cfg.side_length)

    def emit_one(carry, inp):
        rng, alive_count, exhausted, emit_rank = carry
        y, x, count, valid = inp
        can = valid & (~exhausted) & (count < cfg.markers_per_cell)
        if active is not None:
            can = can & active

        # The reference consumes randf() twice inside a single call
        # expression (main.c:288) whose evaluation order C leaves
        # unspecified; the gcc-compiled binary evaluates right-to-left,
        # so the Y jitter draws first.  Verified against the real
        # binary's frames (tests/test_ref_binary.py).
        ry, rng_a = rng_mod.randf32(rng)
        rx, rng_b = rng_mod.randf32(rng_a)
        rng = jnp.where(can, rng_b, rng)

        pos_x = (x.astype(rx.dtype) + rx) * h
        pos_y = (y.astype(ry.dtype) + ry) * h

        rank = emit_rank
        emit_rank = emit_rank + can.astype(jnp.int32)
        alive_count = alive_count + can.astype(jnp.int32)
        exhausted = exhausted | (alive_count == max_count - 1)
        return (rng, alive_count, exhausted, emit_rank), (can, rank, pos_x, pos_y)

    (rng, alive_count, exhausted, _), (cans, ranks, pos_x, pos_y) = jax.lax.scan(
        emit_one,
        (state.rng, state.alive_count, exhausted, jnp.int32(0)),
        (ys, xs, counts_at_src, scn.source_valid),
    )

    # place emitted markers into the first free slots (the reference
    # appends to its compacted array; freed slots here play that role)
    free_slots = jnp.nonzero(~state.alive, size=S, fill_value=0)[0]
    slots = free_slots[jnp.clip(ranks, 0, S - 1)]
    # route non-emitting lanes to a dummy out-of-range slot (dropped)
    slots = jnp.where(cans, slots, cfg.max_markers)

    markers = state.markers.at[0, slots].set(pos_x, mode="drop")
    markers = markers.at[1, slots].set(pos_y, mode="drop")
    alive = state.alive.at[slots].set(True, mode="drop")
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
