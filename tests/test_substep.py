"""One CFL substep of the XLA path (sim.substep: marker pass, sources,
grid stage, projection) on a developing 64² dam break, for each solver
and colour mode: the projected velocity is divergence-free to the
solver's tolerance, and markers are conserved."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from euler_tpu.config import SimConfig, SolverConfig
from euler_tpu.core.presets import dam_break
from euler_tpu.ops.project import divergence_rhs
from euler_tpu.sim import step_frame_jit, substep

SOLVERS = {
    # the converged mode of cli.py / bench.py
    "mg": SolverConfig(preconditioner="mg", tol_rel=1e-4, warm_start=True),
    # the reference's solve: 100 Jacobi-PCG iterations, absolute 1e-6
    "jacobi": SolverConfig(),
}


@pytest.mark.parametrize("rainbow", [False, True], ids=["mono", "rainbow"])
@pytest.mark.parametrize("precon", sorted(SOLVERS))
def test_substep_projects_and_conserves(precon, rainbow):
    cfg = SimConfig(nx=64, ny=64, marker_layout="slots", rainbow=rainbow,
                    solver=SOLVERS[precon])
    scn, st = dam_break(cfg)
    seeded = int(st.alive_count)
    for _ in range(3):
        st = step_frame_jit(cfg, scn, st)

    out, msq, iters = jax.jit(
        lambda st, dt: substep(cfg, scn, st, dt))(st, jnp.float32(0.03))

    # residual r = b - A p leaves div(u) = r * dt / (h^2 rho) on fluid
    # cells; a solve that stops at ||r|| <= 1e-4 ||b|| bounds it by
    # 1e-4 of the pre-projection divergence, itself <= 4 max|u| / h.
    # The reference's 100 Jacobi iterations get further still on a 64²
    # system (measured ~6x below the bound).
    b = divergence_rhs(cfg, out.u, out.v, out.fluid, jnp.float32(1.0))
    div_inf = float(jnp.max(jnp.abs(b)))
    umax = float(jnp.sqrt(msq))
    assert umax > 1.0
    assert div_inf <= 1e-4 * 4 * umax / cfg.side_length
    assert 0 < int(iters) <= cfg.solver.max_iterations

    # walls, no sinks: every seeded marker is alive or counted as dropped
    assert (int(out.alive_count) + int(out.dropped_markers)) == seeded
    assert int(jnp.sum(out.marker_count)) == int(out.alive_count)
    for name in ("u", "v", "r", "g", "b", "p"):
        assert np.isfinite(np.asarray(getattr(out, name))).all(), name
