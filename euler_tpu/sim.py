"""Step orchestration: one frame = up to `max_substeps` CFL substeps.

Reproduces sim_step (/root/reference/main.c:843-900) as a pure
`state -> state` function.  The reference's data-dependent substep loop
(`for step while frame_time > 0 && step < 8`, main.c:851) becomes a
fixed-trip lax.scan with an activity mask — XLA traces one substep once
and the select carries inactive iterations through unchanged, which keeps
the whole frame jittable, vmappable over batched scenarios, and shardable.

Substep ordering (main.c:855-893):
  timestep -> advect markers -> refresh counts -> [rainbow: extrapolate
  colours] -> sources -> extrapolate u,v -> zero_bounds u,v -> advect
  u,v[,colours] -> gravity -> zero_bounds -> project.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from euler_tpu.config import SimConfig
from euler_tpu.core.state import FluidState, Scenario
from euler_tpu.ops.advect import advect_p, advect_u, advect_v
from euler_tpu.ops.extrapolate import extrapolate
from euler_tpu.ops.forces import apply_body_forces, max_speed_sq, zero_bounds
from euler_tpu.ops.markers import get_marker_ops, get_marker_pass
from euler_tpu.ops.project import project


def substep(cfg: SimConfig, scn: Scenario, state: FluidState, dt,
            active=None):
    """One CFL substep (the body of main.c:851-893), dt already chosen.

    Returns (state, msq, iterations) where msq = maxsq(u) + maxsq(v) of
    the projected velocities (main.c:808-820) — the input to the NEXT
    substep's CFL dt — and iterations is the pressure solve's PCG count.

    `active` masks source emission (an inactive substep with dt = 0 is
    then a bitwise no-op on the marker store — see step_frame).

    Each stage runs under a `jax.named_scope`, so a device trace
    attributes its kernels to the stage (tools/profile_step.py)."""
    solid = scn.solid
    _, _, fluid_sources = get_marker_ops(cfg)

    # marker pass (march + re-bin) uses the velocity field and fluid
    # mask from the end of the previous substep (including last
    # substep's source emissions)
    with jax.named_scope("marker_pass"):
        state = get_marker_pass(cfg)(cfg, scn, state, dt)

    with jax.named_scope("grid_stage"):
        if cfg.rainbow:
            # colours extrapolate before sources run (main.c:859-863)
            fluid, prev = state.fluid, state.prev_fluid
            state = state.replace(
                r=extrapolate(cfg, state.r, fluid, prev, "p"),
                g=extrapolate(cfg, state.g, fluid, prev, "p"),
                b=extrapolate(cfg, state.b, fluid, prev, "p"),
            )

    with jax.named_scope("sources"):
        state = fluid_sources(cfg, scn, state, active=active)

    # velocity extrapolation and boundary zeroing see the post-emission
    # fluid mask (emission increments marker_count, main.c:289)
    fluid, prev = state.fluid, state.prev_fluid

    # Inactive substeps must not burn the solver's iteration budget: with
    # dt = 0 (fast path) the RHS k_inv_scale = h^2 rho / dt is inf and the
    # divergence RHS goes NaN, so `rmax <= tol` never fires and every
    # discarded solve ran the full max_iterations.  dt = inf instead makes
    # k_inv_scale = 0 and the RHS EXACTLY zero, so the solvers' all_zero
    # early-out (main.c:742) skips the loop entirely.  Active substeps are
    # bitwise unaffected.
    if active is None:
        dt_proj = dt
    else:
        dt_proj = jnp.where(active, dt, jnp.asarray(jnp.inf, dt.dtype))

    with jax.named_scope("grid_stage"):
        u = extrapolate(cfg, state.u, fluid, prev, "u")
        v = extrapolate(cfg, state.v, fluid, prev, "v")
        u = zero_bounds(cfg, u, fluid, solid, "u")
        v = zero_bounds(cfg, v, fluid, solid, "v")

        ut = advect_u(cfg, u, v, fluid, dt)
        vt = advect_v(cfg, u, v, fluid, dt)
        if cfg.rainbow:
            state = state.replace(
                r=advect_p(cfg, state.r, u, v, fluid, dt),
                g=advect_p(cfg, state.g, u, v, fluid, dt),
                b=advect_p(cfg, state.b, u, v, fluid, dt),
            )

        vt = apply_body_forces(cfg, vt, dt)
        ut = zero_bounds(cfg, ut, fluid, solid, "u")
        vt = zero_bounds(cfg, vt, fluid, solid, "v")

    with jax.named_scope("projection"):
        u2, v2, info = project(cfg, dt_proj, ut, vt, fluid, solid,
                               p0=state.p)
        msq = max_speed_sq(cfg, u2, v2)
    iters = info["iterations"]
    if state.p is not None:
        # the solver may run wider than the state (f64 parity configs);
        # the carry keeps the state dtype
        return state.replace(
            u=u2, v=v2, p=info["pressure"].astype(state.p.dtype)), msq, iters
    return state.replace(u=u2, v=v2), msq, iters


def _tree_select(pred, on_true, on_false):
    return jax.tree.map(lambda a, b: jnp.where(pred, a, b), on_true, on_false)


def _dt_from_msq(cfg: SimConfig, msq, frame_time):
    """calculate_timestep (main.c:834-841) from a precomputed maxsq —
    bitwise the same dt, without re-reducing the velocity planes."""
    f = frame_time.dtype
    max_distance = cfg.cfl * cfg.side_length
    max_velocity = jnp.sqrt(msq.astype(f))
    dt = jnp.where(
        max_velocity > 0.0,
        max_distance / jnp.where(max_velocity > 0.0, max_velocity, 1.0),
        jnp.inf,
    )
    return jnp.minimum(dt, frame_time).astype(f)


def step_frame(cfg: SimConfig, scn: Scenario, state: FluidState) -> FluidState:
    return _step_frame_impl(cfg, scn, state)[0]


def step_frame_stats(cfg: SimConfig, scn: Scenario, state: FluidState):
    """(state', stats): like step_frame, plus the frame's solver counters:

      * stats["active_substeps"]: the number of ACTIVE CFL substeps the
        frame actually ran (the reference's data-dependent loop count,
        main.c:851) — the nominal 8-substep cell-steps metric is
        transparent about the real substep occupancy;
      * stats["pcg_iterations"]: int32 [max_substeps], each substep's PCG
        iteration count (0 for inactive substeps, whose zero RHS exits
        before the loop)."""
    return _step_frame_impl(cfg, scn, state)


def _step_frame_impl(cfg: SimConfig, scn: Scenario, state: FluidState):
    """One 0.1 s frame: masked fixed-trip substep loop + frame counter.

    The CFL maxsq reduction runs once on the incoming state; every
    subsequent substep reuses the maxsq its projection emitted
    (main.c recomputes it per substep, but over exactly the velocities
    the previous projection produced — same value).

    Inactive-substep handling (slot layout): dt = 0 plus a masked
    emission make the marker pass a BITWISE no-op on the marker store
    (positions advance by 0*v, re-binning maps slot k to slot k, the
    emission scan draws nothing), so only the grid fields need the
    activity select, not the [2, K, Y, X] marker planes.  The global
    layout keeps the full tree-select (its swap-remove compaction is
    order-dependent)."""
    f = state.u.dtype
    fast = cfg.marker_layout == "slots"

    def body(carry, _):
        state, frame_time, msq = carry
        active = frame_time > 0.0
        dt = _dt_from_msq(cfg, msq, frame_time)
        # inactive lanes still trace the substep; dt = 0 makes the
        # marker pass an identity (the projection's divide-by-dt infs
        # land only in select-discarded grid fields)
        dt = jnp.where(active, dt, jnp.asarray(0.0 if fast else 1.0, f))
        new_state, new_msq, iters = substep(cfg, scn, state, dt,
                                            active=active)
        if fast:
            sel = lambda a, b: jnp.where(active, a, b)
            state = new_state.replace(
                u=sel(new_state.u, state.u),
                v=sel(new_state.v, state.v),
                r=sel(new_state.r, state.r),
                g=sel(new_state.g, state.g),
                b=sel(new_state.b, state.b),
                prev_marker_count=sel(new_state.prev_marker_count,
                                      state.prev_marker_count),
                # inactive substeps early-out to p = 0; keep the real
                # pressure so the NEXT frame's warm start survives the
                # frame's trailing inactive lanes
                p=(sel(new_state.p, state.p)
                   if state.p is not None else None),
            )
        else:
            state = _tree_select(active, new_state, state)
        msq = jnp.where(active, new_msq.astype(msq.dtype), msq)
        frame_time = jnp.where(active, frame_time - dt, frame_time)
        iters = jnp.where(active, iters, 0).astype(jnp.int32)
        return (state, frame_time, msq), (active, iters)

    frame_time0 = jnp.asarray(cfg.frame_time, f)
    msq0 = max_speed_sq(cfg, state.u, state.v)
    (state, _, _), (actives, iters) = jax.lax.scan(
        body, (state, frame_time0, msq0), None, length=cfg.max_substeps
    )
    stats = {"active_substeps": jnp.sum(actives.astype(jnp.int32)),
             "pcg_iterations": iters}
    return state.replace(frame_count=state.frame_count + 1), stats


@partial(jax.jit, static_argnums=0)
def step_frame_jit(cfg: SimConfig, scn: Scenario, state: FluidState) -> FluidState:
    return step_frame(cfg, scn, state)


def run_frames(cfg: SimConfig, scn: Scenario, state: FluidState, n: int):
    """Scan `n` frames on device (benchmark / headless path)."""

    def body(state, _):
        return step_frame(cfg, scn, state), None

    state, _ = jax.lax.scan(body, state, None, length=n)
    return state


@partial(jax.jit, static_argnums=(0, 3))
def run_frames_jit(cfg: SimConfig, scn, state, n: int):
    return run_frames(cfg, scn, state, n)
