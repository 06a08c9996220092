"""Pressure warm start (cfg.solver.warm_start).

The reference starts every PCG solve from zero (main.c:738-741).  With
warm_start the previous substep's clamped pressure seeds the next solve
while the stopping tolerance stays anchored to ||b||_inf — so converged
results agree with a cold solve to the solver tolerance, with fewer
iterations.  Covers the MG-PCG solve (x0), the projection (p0
re-masked to the current fluid), whole frames (the pressure carry), and
inactive substeps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from euler_tpu.config import SimConfig, SolverConfig
from euler_tpu.core.presets import dam_break
from euler_tpu.ops.project import (
    divergence_rhs,
    pressure_matrix_diag,
    project,
    solve_pressure,
)
from euler_tpu.sim import step_frame_jit, step_frame_stats


def _cfg(**solver_kw):
    kw = dict(max_iterations=200, dtype="float32", tol_rel=1e-5,
              preconditioner="mg")
    kw.update(solver_kw)
    return SimConfig(nx=64, ny=64, marker_layout="slots",
                     solver=SolverConfig(**kw))


def _warm(cfg, **kw):
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, warm_start=True, **kw))


def _developed(cfg, frames=4):
    scn, st = dam_break(cfg)
    for _ in range(frames):
        st = step_frame_jit(cfg, scn, st)
    return scn, st


def _system(cfg, scn, st, dt):
    fluid = st.fluid
    b = divergence_rhs(cfg, st.u, st.v, fluid, dt)
    a_diag = pressure_matrix_diag(cfg, scn.solid, fluid)
    return b, a_diag, fluid


def test_pcg_loop_warm_same_solution_fewer_iters():
    cfg = _cfg()
    scn, st = _developed(cfg)
    dt = jnp.float32(0.03)
    b, a_diag, fluid = _system(cfg, scn, st, dt)

    p_cold, it_cold, r_cold = solve_pressure(cfg, b, a_diag, fluid,
                                             scn.solid)
    # seed with a slightly perturbed converged solution — the shape a
    # previous substep's pressure has
    x0 = jnp.where(fluid, p_cold * 1.01, 0.0)
    p_warm, it_warm, r_warm = solve_pressure(
        _warm(cfg), b, a_diag, fluid, scn.solid, x0=x0)

    bn = float(jnp.max(jnp.abs(b)))
    assert float(r_warm) <= max(cfg.solver.tol, cfg.solver.tol_rel * bn)
    assert int(it_warm) < int(it_cold)
    np.testing.assert_allclose(np.asarray(p_warm), np.asarray(p_cold),
                               atol=5e-3 * max(1.0, bn * 1e-3))


def test_pcg_loop_warm_zero_rhs_exact_zero():
    """All-zero RHS (inactive substep) must yield p = 0 exactly even
    with a nonzero guess (the reference early-out, main.c:742)."""
    cfg = _cfg()
    scn, st = _developed(cfg)
    fluid = st.fluid
    a_diag = pressure_matrix_diag(cfg, scn.solid, fluid)
    b = jnp.zeros_like(st.u)
    x0 = jnp.where(fluid, 3.7, 0.0).astype(jnp.float32)
    p, iters, resid = solve_pressure(_warm(cfg), b,
                                     a_diag, fluid, scn.solid, x0=x0)
    assert int(iters) == 0
    assert float(jnp.max(jnp.abs(p))) == 0.0


def test_mg_pcg_x0_converged_guess_accepted():
    """XLA MG-PCG seeded with the converged solution: accepted before
    the first iteration, same solution as the cold solve."""
    cfg = _cfg()
    scn, st = _developed(cfg)
    dt = jnp.float32(0.03)
    b, a_diag, fluid = _system(cfg, scn, st, dt)

    p_cold, it_cold, r_cold = solve_pressure(cfg, b, a_diag, fluid,
                                             scn.solid)
    x0 = jnp.where(fluid, p_cold, 0.0)
    p_warm, it_warm, r_warm = solve_pressure(_warm(cfg), b, a_diag, fluid,
                                             scn.solid, x0=x0)
    bn = float(jnp.max(jnp.abs(b)))
    tol = max(cfg.solver.tol, cfg.solver.tol_rel * bn)
    assert int(it_cold) > 0
    assert int(it_warm) == 0
    assert float(r_warm) <= tol
    np.testing.assert_allclose(np.asarray(p_warm), np.asarray(p_cold),
                               atol=1e-4 * max(1.0, bn))


def test_project_masks_stale_fluid_guess():
    """Guess cells that are no longer fluid must not leak into the
    iterate: project() re-masks p0 to the current fluid cells."""
    cfg = _warm(_cfg())
    scn, st = _developed(cfg)
    dt = jnp.float32(0.03)
    _, _, info_cold = project(_cfg(), dt, st.u, st.v, st.fluid, scn.solid)
    p0 = jnp.where(st.fluid, info_cold["pressure"], 123.0)  # garbage outside
    _, _, info = project(cfg, dt, st.u, st.v, st.fluid, scn.solid, p0=p0)
    p = np.asarray(info["pressure"])
    assert not p[~np.asarray(st.fluid)].any()
    b, _, _ = _system(cfg, scn, st, dt)
    np.testing.assert_allclose(
        p, np.asarray(info_cold["pressure"]),
        atol=1e-4 * max(1.0, float(jnp.max(jnp.abs(b)))))


def test_step_frame_warm_frames_match_cold():
    """Whole frames through sim.py: warm vs cold stay within solver
    tolerance of each other and marker motion is identical."""
    cfg = _cfg(tol_rel=1e-4)
    cfgw = _warm(cfg)
    scn, st = dam_break(cfg)
    s_cold, s_warm = st, st
    for _ in range(4):
        s_cold = step_frame_jit(cfg, scn, s_cold)
        s_warm = step_frame_jit(cfgw, scn, s_warm)
    du = float(jnp.max(jnp.abs(s_cold.u - s_warm.u)))
    dv = float(jnp.max(jnp.abs(s_cold.v - s_warm.v)))
    assert du < 5e-3 and dv < 5e-3
    assert int(jnp.sum(jnp.abs(
        s_cold.marker_count - s_warm.marker_count))) == 0
    # the warm run carries a pressure plane across frames
    assert float(jnp.max(s_warm.p)) > 0.0


def test_inactive_substep_warm_zero():
    """Inactive substep (dt_proj = inf, zero RHS) with a nonzero p0: the
    projected pressure is exactly zero and the solve runs 0 iterations,
    even with a warm guess; step_frame's select discards the inactive
    substeps' outputs, so a warm frame with inactive substeps stays
    finite."""
    cfg = _warm(_cfg())
    scn, st = _developed(_cfg())
    p0 = jnp.where(st.fluid, 2.5, 0.0).astype(jnp.float32)
    _, _, info = project(cfg, jnp.float32(np.inf), st.u, st.v, st.fluid,
                         scn.solid, p0=p0)
    assert int(info["iterations"]) == 0
    assert float(jnp.max(jnp.abs(info["pressure"]))) == 0.0

    out, stats = jax.jit(step_frame_stats, static_argnums=0)(cfg, scn, st)
    active = int(stats["active_substeps"])
    assert 0 < active < cfg.max_substeps
    assert not np.asarray(stats["pcg_iterations"])[active:].any()
    assert np.isfinite(np.asarray(out.u)).all()
    assert np.isfinite(np.asarray(out.v)).all()
    assert np.isfinite(np.asarray(out.p)).all()


def test_project_op_path_carries_pressure():
    cfg = _warm(_cfg())
    scn, st = _developed(cfg)
    dt = jnp.float32(0.03)
    u2, v2, info = project(cfg, dt, st.u, st.v, st.fluid, scn.solid,
                           p0=st.p)
    assert info["pressure"].shape == st.u.shape
    # clamped: nonnegative, zero outside fluid
    p = np.asarray(info["pressure"])
    assert (p >= 0).all()
    assert (p[~np.asarray(st.fluid)] == 0).all()
