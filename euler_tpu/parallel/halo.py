"""Explicit shard_map domain decomposition with ppermute halo exchange.

The GSPMD path (euler_tpu.parallel.mesh) lets XLA's partitioner insert
communication automatically.  This module is the hand-rolled alternative
for the solver hot loop: grid rows are block-sharded over a mesh axis,
the 5-point stencil's neighbour rows travel via jax.lax.ppermute (one
exchange per direction), and the PCG reductions are jax.lax.psum —
the stencil analogue of ring-attention-style sequence parallelism
(SURVEY.md §5 "long-context").

Used for scale-out pressure solves; correctness is pinned against the
single-device solver in tests/test_halo.py on the virtual CPU mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from euler_tpu.config import SimConfig


def halo_exchange_rows(x, axis_name: str):
    """Return (below, above): the neighbour shards' edge rows.

    `below[0]` is the last row of the previous shard (zeros at the global
    bottom edge), `above[0]` the first row of the next shard (zeros at the
    global top).  One ppermute per direction.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    top_row = x[-1:]      # send up
    bottom_row = x[:1]    # send down

    below = jax.lax.ppermute(
        top_row, axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    above = jax.lax.ppermute(
        bottom_row, axis_name, [(i + 1, i) for i in range(n - 1)]
    )
    below = jnp.where(idx == 0, jnp.zeros_like(below), below)
    above = jnp.where(idx == n - 1, jnp.zeros_like(above), above)
    return below, above


def halo_exchange_cols(x, axis_name: str):
    """Column analogue of halo_exchange_rows for 2D domain decomposition.

    Returns (left, right): the previous shard's last column and the next
    shard's first column (zeros at the global edges)."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    last_col = x[:, -1:]   # send right
    first_col = x[:, :1]   # send left

    left = jax.lax.ppermute(
        last_col, axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    right = jax.lax.ppermute(
        first_col, axis_name, [(i + 1, i) for i in range(n - 1)]
    )
    left = jnp.where(idx == 0, jnp.zeros_like(left), left)
    right = jnp.where(idx == n - 1, jnp.zeros_like(right), right)
    return left, right


def _apply_a_local(a_diag, fluid, s, axis_names):
    """Masked 5-point Laplacian on a (row[, column])-shard with halo
    exchange: one ppermute hop per direction per sharded axis."""
    below, above = halo_exchange_rows(s, axis_names[0])
    up = jnp.concatenate([s[1:], above], axis=0)        # s[y+1]
    down = jnp.concatenate([below, s[:-1]], axis=0)     # s[y-1]
    if len(axis_names) > 1:
        lh, rh = halo_exchange_cols(s, axis_names[1])
        left = jnp.concatenate([lh, s[:, :-1]], axis=1)   # s[x-1]
        right = jnp.concatenate([s[:, 1:], rh], axis=1)   # s[x+1]
    else:
        left = jnp.pad(s[:, :-1], ((0, 0), (1, 0)))
        right = jnp.pad(s[:, 1:], ((0, 0), (0, 1)))
    lap = a_diag.astype(s.dtype) * s - (left + right + up + down)
    return jnp.where(fluid, lap, 0)


def _pcg_sharded(cfg: SimConfig, axis_names, b, a_diag, fluid):
    """PCG, one shard per device: ops/project.pcg_loop (the ONE PCG
    body — break placement, all_zero early-out, tol_rel stopping) with
    psum/pmax reductions and the halo-exchanging local apply plugged in.

    Preconditioners (both communication-free per CG iteration):
      * "jacobi" — the diagonal, trivially block-local.
      * "mg" — block-Jacobi additive Schwarz: each shard runs one
        Galerkin multigrid cycle (ops/multigrid.cycle_galerkin) on its
        OWN principal submatrix A_ii.  Building the fine edge level from
        the local fluid block drops exactly the couplings that cross the
        shard boundary (shift_* pull zeros there), so the local operator
        IS A_ii — symmetric positive definite — and the induced
        M = diag(MG(A_11), ..., MG(A_nn)) is a valid SPD PCG
        preconditioner.  Outer iterations grow mildly with the shard
        count (boundary error is re-propagated by CG, the classic
        one-level-Schwarz trade), but each costs only a local V/W-cycle
        plus the two psum dots — no extra communication vs jacobi.
    """
    from euler_tpu.ops.project import pcg_loop

    sdt = b.dtype
    psum = partial(jax.lax.psum, axis_name=axis_names)
    pmax = partial(jax.lax.pmax, axis_name=axis_names)

    if cfg.solver.preconditioner == "mg":
        from euler_tpu.ops.multigrid import (
            build_galerkin_hierarchy, cycle_galerkin,
        )

        levels = build_galerkin_hierarchy(
            a_diag, fluid, sdt, min_size=cfg.solver.mg_min_size
        )
        mg_cycle = partial(
            cycle_galerkin, levels,
            pre=cfg.solver.mg_pre_smooth, post=cfg.solver.mg_post_smooth,
            coarse_iters=cfg.solver.mg_coarse_iters,
            w=2 if cfg.solver.mg_cycle == "w" else 1,
            smoother=cfg.solver.mg_smoother,
            cheby_degree=cfg.solver.mg_cheby_degree,
            cheby_ratio=cfg.solver.mg_cheby_ratio,
            coarse_ratio=cfg.solver.mg_coarse_ratio,
            w_depth=cfg.solver.mg_w_depth,
        )

        def precon(r):
            return jnp.where(fluid, mg_cycle(r), 0)
    else:
        def precon(r):
            d = a_diag.astype(sdt)
            z = r / jnp.where(d > 0, d, 1)
            return jnp.where(fluid & (a_diag > 0), z, jnp.where(fluid, r, 0))

    p, iters, resid = pcg_loop(
        cfg, b,
        lambda s: _apply_a_local(a_diag, fluid, s, axis_names),
        precon,
        dot=lambda x, y: psum(jnp.sum(x * y)),
        inf_norm=lambda r: pmax(jnp.max(jnp.abs(r))),
    )
    return p, iters, resid


def make_sharded_pressure_solver(cfg: SimConfig, mesh: Mesh,
                                 axes: tuple[str, ...] = ("y",),
                                 stats: bool = False):
    """jit-compiled domain-decomposed pressure solver over `mesh[axes]`.

    axes = ("y",) row-shards the grid; axes = ("y", "x") block-shards it
    in 2D with column halo exchange as well.  Inputs/outputs are [Y, X]
    arrays sharded P(*axes); each grid dim must divide by its axis size.
    stats=True additionally returns (iters, resid) — replicated scalars
    (both derive from psum/pmax-reduced quantities, so every shard holds
    the same value).
    """
    spec = P(axes[0], axes[1] if len(axes) > 1 else None)

    def body(b, a_diag, fluid):
        p, iters, resid = _pcg_sharded(cfg, axes, b, a_diag, fluid)
        return (p, iters, resid) if stats else p

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, P(), P()) if stats else spec,
        check_vma=False,
    )
    sharding = NamedSharding(mesh, spec)
    return jax.jit(fn, in_shardings=(sharding,) * 3,
                   out_shardings=(sharding, None, None) if stats else sharding)
