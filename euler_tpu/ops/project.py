"""Pressure projection: masked preconditioned conjugate gradient.

Reproduces project (/root/reference/main.c:709-806):

* RHS b = -div(u) * density * h^2 / dt on fluid cells (main.c:713-724);
  the divergence is accumulated in float and widened, as in C's mixed
  float/double expression.
* Matrix A: diagonal = count of non-solid neighbours (main.c:554-559),
  off-diagonals -1 towards fluid neighbours (main.c:561-575), applied
  matrix-free as a 5-point stencil (apply_a main.c:679-691).
* PCG loop (main.c:738-767): max_iterations / tol on the residual
  infinity norm, with the exact break placement (the tolerance is checked
  after the p/r update, before re-preconditioning).
* Pressure clamped >= 0 (main.c:769-779) before the 3-way
  solid/fluid/air face velocity update (main.c:782-806).

Preconditioning: the reference uses serial incomplete Cholesky
(main.c:580-627) whose triangular sweeps do not parallelise; the
default here is Jacobi (z = r / diag), fully data-parallel.  Both
are *preconditioners*: the tolerance-based stopping rule makes the
converged pressure agree within float tolerance regardless of the choice.

Every iterate (r, z, s, p) is kept exactly zero outside the fluid mask, so
plain dense reductions equal the reference's fluid-masked ones
(dot main.c:629-639, inf_norm main.c:654-667).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from euler_tpu.config import SimConfig
from euler_tpu.core.state import (
    shift_down,
    shift_left,
    shift_right,
    shift_up,
    u_property,
    v_property,
    valid_region,
)


def divergence_rhs(cfg: SimConfig, u, v, fluid, dt):
    """b = -div(u) * density * h^2 / dt on fluid cells (main.c:713-724)."""
    sdt = jnp.dtype(cfg.solver.dtype)
    inv_h = jnp.asarray(1.0 / cfg.side_length, u.dtype)
    div = (u - shift_left(u) + v - shift_down(v)) * inv_h
    # C computes h^2 * rho / dt in float then widens (main.c:713).
    k_inv_scale = (
        jnp.asarray(cfg.side_length * cfg.side_length * cfg.density, u.dtype)
        / dt.astype(u.dtype)
    )
    b = -(div.astype(sdt)) * k_inv_scale.astype(sdt)
    return jnp.where(fluid, b, 0).astype(sdt)


def pressure_matrix_diag(cfg: SimConfig, solid, fluid):
    """a_diag = 4 - #solid neighbours, on fluid cells (main.c:554-559)."""
    s = solid.astype(jnp.int32)
    diag = 4 - (shift_left(s) + shift_right(s) + shift_down(s) + shift_up(s))
    return jnp.where(fluid, diag, 0)


def apply_a(a_diag, fluid, s):
    """5-point Laplacian application (main.c:679-691).

    `s` must be zero outside the fluid, so the fluid-neighbour masking of
    the reference reduces to plain shifts.
    """
    lap = a_diag.astype(s.dtype) * s - (
        shift_left(s) + shift_right(s) + shift_down(s) + shift_up(s)
    )
    return jnp.where(fluid, lap, 0)


def _make_preconditioner(cfg: SimConfig, a_diag, fluid, solid, dtype):
    kind = cfg.solver.preconditioner
    if kind == "jacobi":

        def precon(r):
            d = a_diag.astype(r.dtype)
            z = r / jnp.where(d > 0, d, 1)
            return jnp.where(fluid & (a_diag > 0), z, jnp.where(fluid, r, 0))

        return precon
    if kind == "mg":
        if solid is None:
            raise ValueError("mg preconditioner needs the solid mask")
        from euler_tpu.ops.multigrid import make_mg_preconditioner

        return make_mg_preconditioner(cfg, solid, fluid, dtype, a_diag=a_diag)
    if kind == "ic0":
        from euler_tpu.ops.ic0 import make_ic0_preconditioner

        return make_ic0_preconditioner(a_diag, fluid, dtype)
    if kind == "none":
        return lambda r: jnp.where(fluid, r, 0)
    raise NotImplementedError(f"preconditioner {kind!r}")


def _masked_dot(a, b):
    # Iterates are zero outside the fluid, so a dense reduction equals the
    # reference's fluid-masked dot (main.c:629-639).
    return jnp.sum(a * b)


def _inf_norm(r):
    return jnp.max(jnp.abs(r))


def pcg_loop(cfg: SimConfig, b, apply_fn, precon, dot=None, inf_norm=None,
             x0=None):
    """The PCG recurrence of main.c:738-767, parameterised over its
    communication primitives so single-device and domain-decomposed
    solvers share ONE body (parallel/halo.py plugs in psum/pmax
    reductions and a halo-exchanging apply; everything here — break
    placement, all_zero early-out, tol_rel stopping — is common).

    `x0` (optional, must be zero outside the fluid) warm-starts the
    iteration; the stopping tolerance stays anchored to ||b||_inf, so
    the converged solution meets exactly the cold solve's tolerance.

    Returns (p, iterations, residual)."""
    sdt = b.dtype
    max_iters = cfg.solver.max_iterations
    dot = _masked_dot if dot is None else dot
    inf_norm = _inf_norm if inf_norm is None else inf_norm

    b_norm = inf_norm(b)
    # ||r|| <= max(tol, tol_rel * ||b||)  (tol_rel = 0 -> reference rule)
    tol = jnp.maximum(
        jnp.asarray(cfg.solver.tol, sdt),
        jnp.asarray(cfg.solver.tol_rel, sdt) * b_norm,
    )
    # all_zero early-out (main.c:742): an exactly-zero RHS skips the loop.
    nonzero = b_norm != 0
    if x0 is None:
        p = jnp.zeros_like(b)
        r = b
        done0 = ~nonzero
    else:
        p = jnp.where(nonzero, x0, 0).astype(sdt)
        r = b - apply_fn(p)
        # the guess may already satisfy the tolerance (NaN-robust form)
        done0 = (~nonzero) | jnp.logical_not(inf_norm(r) > tol)
    z = precon(r)
    s = z
    sigma = dot(z, r)

    def cond(carry):
        p, r, s, sigma, i, done = carry
        return (~done) & (i < max_iters)

    def body(carry):
        p, r, s, sigma, i, done = carry
        As = apply_fn(s)
        zs = dot(As, s)
        alpha = sigma / jnp.where(zs != 0, zs, 1)
        p = p + alpha * s
        r = r - alpha * As
        # NaN-robust form: an inactive substep's dt = 0 makes b (and
        # hence r) NaN, and `rmax <= tol` would never fire — burning
        # the full iteration budget on a solve whose result is
        # select-discarded.  ~(rmax > tol) exits after one iteration
        # instead; identical on real numbers (main.c:756 semantics).
        conv = jnp.logical_not(inf_norm(r) > tol)
        z = precon(r)
        sigma_new = dot(z, r)
        beta = sigma_new / jnp.where(sigma != 0, sigma, 1)
        s = z + beta * s
        return (p, r, s, sigma_new, i + 1, conv)

    p, r, s, sigma, iters, done = jax.lax.while_loop(
        cond, body, (p, r, s, sigma, jnp.int32(0), done0)
    )
    return p, iters, inf_norm(r)


def solve_pressure(cfg: SimConfig, b, a_diag, fluid, solid=None, x0=None):
    """PCG for A p = b (main.c:738-767).  Returns (p, iterations, resid).

    `x0` (from cfg.solver.warm_start) seeds the iteration."""
    with jax.named_scope("mg_hierarchy"):
        precon = _make_preconditioner(cfg, a_diag, fluid, solid, b.dtype)
    with jax.named_scope("pcg_solve"):
        return pcg_loop(cfg, b, lambda s: apply_a(a_diag, fluid, s), precon,
                        x0=x0)


def project(cfg: SimConfig, dt, u, v, fluid, solid, p0=None):
    """Full projection (main.c:709-806): returns (u_out, v_out, info).

    `p0` (cfg.solver.warm_start): previous substep's pressure as the
    solve's initial guess; it is re-masked to the CURRENT fluid cells
    (markers moved since) so iterates stay exactly zero outside the
    fluid — the invariant the masked dot/norm equivalences need."""
    f = u.dtype
    b = divergence_rhs(cfg, u, v, fluid, dt)
    a_diag = pressure_matrix_diag(cfg, solid, fluid)
    x0 = None
    if p0 is not None and cfg.solver.warm_start:
        x0 = jnp.where(fluid, p0, 0).astype(b.dtype)
    p, iters, resid = solve_pressure(cfg, b, a_diag, fluid, solid, x0=x0)

    # pressure clamp >= 0 (main.c:773-779)
    p = jnp.where(fluid, jnp.maximum(p, 0), 0)

    neg_inv_rho_h = jnp.asarray(-1.0 / (cfg.density * cfg.side_length), f)
    dtf = dt.astype(f)

    u_region = valid_region(cfg, "u")
    u_solid = u_property(solid)
    u_fluid = u_property(fluid)
    dp_x = (shift_right(p) - p).astype(f)
    u_upd = u + (neg_inv_rho_h * dp_x) * dtf
    u_out = jnp.where(
        u_region & ~u_solid & u_fluid, u_upd, 0.0
    ).astype(f)

    v_region = valid_region(cfg, "v")
    v_solid = v_property(solid)
    v_fluid = v_property(fluid)
    dp_y = (shift_up(p) - p).astype(f)
    v_upd = v + (neg_inv_rho_h * dp_y) * dtf
    v_out = jnp.where(
        v_region & ~v_solid & v_fluid, v_upd, 0.0
    ).astype(f)

    return u_out, v_out, {"pressure": p, "iterations": iters, "residual": resid}
