"""The converged-mode pressure solve — masked PCG preconditioned by the
Galerkin multigrid W-cycle (ops/project.py, ops/multigrid.py) — against
a scipy sparse direct solve in float64, on the geometries the solve has
to cover: power-of-two, non-power-of-two and odd grids, hierarchy levels
that need padding, all-solid rows, speckled free surfaces, no fluid and
a zero right-hand side."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from euler_tpu.config import SimConfig, SolverConfig
from euler_tpu.ops import project as P

TOL_REL = 1e-10


def _geometry(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    shapes = {"pow2_64": (64, 64), "non_pow2_96x80": (96, 80),
              "odd_75x61": (75, 61), "odd_level_40x100": (40, 100),
              "solid_rows_64": (64, 64), "speckled_128x64": (128, 64),
              "no_fluid_48": (48, 48), "zero_rhs_64": (64, 64)}
    Y, X = shapes[name]
    solid = np.zeros((Y, X), bool)
    solid[0] = solid[-1] = True
    solid[:, 0] = solid[:, -1] = True
    fluid = np.zeros((Y, X), bool)
    fluid[1: int(0.7 * Y), 1: int(0.6 * X)] = True  # a dam of liquid
    if name == "solid_rows_64":
        solid[20] = True  # full-width walls split the liquid
        solid[40, :] = True
    if name == "speckled_128x64":
        fluid[1:-1, 1:-1] = rng.random((Y - 2, X - 2)) > 0.25
    if name == "no_fluid_48":
        fluid[:] = False
    fluid &= ~solid
    b = rng.standard_normal((Y, X)) * fluid
    if name == "zero_rhs_64":
        b[:] = 0.0
    # level sizes that turn odd before mg_min_size exercise the padding
    min_size = 8 if name in ("odd_level_40x100", "odd_75x61") else 32
    return solid, fluid, b, min_size


def _direct(a_diag, fluid, b):
    """A p = b on the fluid cells (main.c:554-575's matrix), float64."""
    Y, X = fluid.shape
    idx = -np.ones((Y, X), int)
    ys, xs = np.nonzero(fluid)
    idx[ys, xs] = np.arange(len(ys))
    rows, cols, vals = [], [], []
    for i, (y, x) in enumerate(zip(ys, xs)):
        rows.append(i), cols.append(i), vals.append(float(a_diag[y, x]))
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            yy, xx = y + dy, x + dx
            if 0 <= yy < Y and 0 <= xx < X and fluid[yy, xx]:
                rows.append(i), cols.append(idx[yy, xx]), vals.append(-1.0)
    p = np.zeros((Y, X))
    if len(ys):
        A = sp.csc_matrix((vals, (rows, cols)), shape=(len(ys), len(ys)))
        p[ys, xs] = spla.spsolve(A, b[ys, xs])
    return p


@pytest.mark.parametrize("name", [
    "pow2_64", "non_pow2_96x80", "odd_75x61", "odd_level_40x100",
    "solid_rows_64", "speckled_128x64", "no_fluid_48", "zero_rhs_64",
])
def test_mg_pcg_matches_direct_solve(name):
    solid, fluid, b, min_size = _geometry(name)
    Y, X = fluid.shape
    cfg = SimConfig(nx=X, ny=Y, solver=SolverConfig(
        preconditioner="mg", dtype="float64", max_iterations=100,
        tol=0.0, tol_rel=TOL_REL, mg_min_size=min_size))
    a_diag = P.pressure_matrix_diag(cfg, jnp.asarray(solid),
                                    jnp.asarray(fluid))
    p, iters, resid = P.solve_pressure(
        cfg, jnp.asarray(b), a_diag, jnp.asarray(fluid), jnp.asarray(solid))
    p = np.asarray(p)
    b_norm = float(np.abs(b).max())

    ref = _direct(np.asarray(a_diag), fluid, b)
    if b_norm == 0.0:
        # the all-zero early-out (main.c:742)
        assert int(iters) == 0 and not p.any()
        return
    # converged by the tolerance rule, well inside the budget: the
    # W-cycle keeps the count level-independent
    assert float(resid) <= TOL_REL * b_norm
    assert 0 < int(iters) < 40
    assert not p[~fluid].any()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(p, ref, atol=1e-6 * scale)
