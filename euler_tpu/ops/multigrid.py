"""Geometric multigrid V-cycle preconditioner for the pressure solve.

The reference preconditions PCG with serial incomplete Cholesky
(main.c:580-627) — two loop-carried triangular sweeps that cannot map to
data-parallel hardware.  Multigrid is the data-parallel answer at scale: every
ingredient (damped-Jacobi smoothing, 2x2 residual restriction, constant
prolongation, masked 5-point operators) is a dense stencil op, and the
iteration count of the outer PCG becomes grid-size independent instead
of growing like O(n) (plain/Jacobi PCG at 1024² does not converge within
the reference's 100-iteration budget; MG-PCG does in ~10).

Scheme (after McAdams et al. 2010-style mask coarsening):
  * coarse cell is fluid if ANY of its 2x2 fine cells is fluid, solid if
    ALL are solid; everything else is air (Dirichlet p=0), matching the
    fine-level boundary conventions (main.c:554-575: solid neighbours
    drop out of the diagonal, air neighbours keep Dirichlet coupling);
  * rediscretized coarse operator (same masked 5-point stencil);
  * cell-centred bilinear prolongation (9/16, 3/16, 3/16, 1/16 weights)
    with its exact adjoint as restriction, scaled so the dx_c² = 4 dx²
    factor folds in (total restriction mass 4);
  * red-black Gauss-Seidel pre/post smoothing in symmetric colour order
    (red-black pre, black-red post), so the V-cycle is a fixed symmetric
    positive operator suitable as a PCG preconditioner.

Odd grid sizes are padded with air at each level; padded cells are
non-fluid and drop out of every masked op.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax.numpy as jnp

from euler_tpu.config import SimConfig
from euler_tpu.core.state import shift_down, shift_left, shift_right, shift_up


class MGLevel(NamedTuple):
    fluid: jnp.ndarray   # bool [Y, X]
    a_diag: jnp.ndarray  # int32 [Y, X]
    inv_diag: jnp.ndarray  # dtype [Y, X], 1/diag on fluid (safe elsewhere)


def _pad_even(a, fill):
    Y, X = a.shape
    py, px = Y % 2, X % 2
    if py or px:
        a = jnp.pad(a, ((0, py), (0, px)), constant_values=fill)
    return a


def _rediscretize(solid, fluid, dtype):
    s = solid.astype(jnp.int32)
    diag = 4 - (shift_left(s) + shift_right(s) + shift_down(s) + shift_up(s))
    a_diag = jnp.where(fluid, diag, 0)
    inv = jnp.where(fluid & (a_diag > 0), 1.0, 0.0).astype(dtype) / jnp.maximum(
        a_diag, 1
    ).astype(dtype)
    return a_diag, inv


def build_hierarchy(solid, fluid, dtype, min_size: int = 32, max_levels: int = 16):
    """List of MGLevel from fine to coarse (level 0 = input grid)."""
    levels = []
    cur_solid, cur_fluid = solid, fluid
    for _ in range(max_levels):
        a_diag, inv = _rediscretize(cur_solid, cur_fluid, dtype)
        levels.append(MGLevel(cur_fluid, a_diag, inv))
        Y, X = cur_fluid.shape
        if min(Y, X) <= min_size:
            break
        f = _pad_even(cur_fluid, False)
        s = _pad_even(cur_solid, True)  # outside counts as solid for "all"
        Y2, X2 = f.shape
        cur_fluid = f.reshape(Y2 // 2, 2, X2 // 2, 2).any(axis=(1, 3))
        cur_solid = s.reshape(Y2 // 2, 2, X2 // 2, 2).all(axis=(1, 3))
        cur_solid = cur_solid & ~cur_fluid
    return levels


def _apply_a(level: MGLevel, x):
    lap = level.a_diag.astype(x.dtype) * x - (
        shift_left(x) + shift_right(x) + shift_down(x) + shift_up(x)
    )
    return jnp.where(level.fluid, lap, 0)


def _checkerboard(shape):
    yy = jnp.arange(shape[0])[:, None]
    xx = jnp.arange(shape[1])[None, :]
    return ((yy + xx) & 1) == 0


def _smooth(level: MGLevel, x, b, iters: int, omega: float,
            reverse: bool = False):
    """Red-black Gauss-Seidel: two coloured half-sweeps per iteration.

    Fully data-parallel (each colour updates independently given the
    other) with a much better smoothing factor than damped Jacobi; this
    is the standard data-parallel multigrid smoother.  `omega` = 1 is
    plain RB-GS.  `reverse` flips the colour order (used for
    post-smoothing so the V-cycle operator is symmetric).
    """
    import jax

    w = jnp.asarray(omega, x.dtype)
    red = _checkerboard(x.shape)
    first, second = (~red, red) if reverse else (red, ~red)

    def half(x, color_mask):
        r = b - _apply_a(level, x)
        return x + jnp.where(color_mask, w * r * level.inv_diag, 0)

    def body(_, x):
        x = half(x, first)
        return half(x, second)

    # fori_loop rather than Python unrolling: long unrolled smoother
    # chains trigger superlinear XLA compile/execute costs.
    x = jax.lax.fori_loop(0, iters, body, x, unroll=2)
    return jnp.where(level.fluid, x, 0)


# Cell-centred bilinear transfer weights: a fine cell at parity (a, b)
# inside its coarse parent interpolates 3/4 from the parent and 1/4 from
# the neighbour on each axis -> tensor weights 9/16, 3/16, 3/16, 1/16.
_W0, _W1 = 0.75, 0.25


def _prolong(e, fine_shape):
    """Bilinear prolongation (coarse [Yc, Xc] -> fine [2Yc, 2Xc], cropped)."""
    ny = {0: shift_down(e), 1: shift_up(e)}        # y-axis neighbour per parity
    nx = {0: shift_left(e), 1: shift_right(e)}     # x-axis neighbour per parity

    def quad(a, b):
        nxy = shift_left(ny[a]) if b == 0 else shift_right(ny[a])
        return (_W0 * _W0) * e + (_W0 * _W1) * nx[b] \
            + (_W1 * _W0) * ny[a] + (_W1 * _W1) * nxy

    Yc, Xc = e.shape
    # interleave quadrants: up[2i+a, 2j+b] = quad(a, b)[i, j]
    rows = jnp.stack([jnp.stack([quad(a, b) for b in (0, 1)], axis=-1)
                      for a in (0, 1)], axis=1)      # [Yc, 2, Xc, 2]
    up = rows.reshape(2 * Yc, 2 * Xc)
    return up[: fine_shape[0], : fine_shape[1]]


def _restrict(r):
    """Exact adjoint of _prolong, total mass 4 (folds in dx_c² = 4 dx²)."""
    r = _pad_even(r, 0)
    Y, X = r.shape
    q = r.reshape(Y // 2, 2, X // 2, 2)
    out = 0.0
    for a in (0, 1):
        opp_y = shift_up if a == 0 else shift_down   # adjoint of parity shift
        for b in (0, 1):
            opp_x = shift_right if b == 0 else shift_left
            f = q[:, a, :, b]
            out = out + (_W0 * _W0) * f + (_W0 * _W1) * opp_x(f) \
                + (_W1 * _W0) * opp_y(f) + (_W1 * _W1) * opp_x(opp_y(f))
    return out


def v_cycle(levels, b, lvl: int = 0, pre: int = 2, post: int = 2,
            coarse_iters: int = 24, omega: float = 1.0):
    level = levels[lvl]
    b = jnp.where(level.fluid, b, 0)
    if lvl == len(levels) - 1:
        # Coarsest solve: k forward sweeps then k reversed sweeps.  The
        # reversed pass is the transpose of the forward pass, making the
        # induced solve operator exactly symmetric (required for PCG).
        x = _smooth(level, jnp.zeros_like(b), b, coarse_iters, omega)
        return _smooth(level, x, b, coarse_iters, omega, reverse=True)
    x = _smooth(level, jnp.zeros_like(b), b, pre, omega)
    r = jnp.where(level.fluid, b - _apply_a(level, x), 0)
    rc = _restrict(r)
    ec = v_cycle(levels, rc, lvl + 1, pre, post, coarse_iters, omega)
    ec = jnp.where(levels[lvl + 1].fluid, ec, 0)
    x = x + jnp.where(level.fluid, _prolong(ec, b.shape), 0)
    return _smooth(level, x, b, post, omega, reverse=True)




# ---------------------------------------------------------------------------
# Galerkin hierarchy: exact coarse operators A_c = P^T A P with
# piecewise-constant prolongation.
#
# The rediscretized hierarchy above coarsens the MASKS and rebuilds the
# 5-point operator, which loses the free-surface Dirichlet geometry on
# coarse levels (an any-fluid 2x2 block absorbs its air cells) — measured
# V-cycle rate ~0.65 at 1024² (PERF.md "Solve convergence").  The Galerkin
# operator needs no mask heuristics: with P = "each fine cell takes its
# 2x2-parent's value" (masked to fluid) and R = P^T (2x2 block sum), the
# coarse operator P^T A P encodes exactly how much Dirichlet boundary each
# coarse cell's support touches — and, unlike bilinear prolongation (whose
# cell-centred RAP has reach 2, a 25-point stencil), it stays 5-POINT at
# every level, with real-valued per-edge weights:
#
#   c_c[I,J] = sum of the block's diagonal entries
#              + 2 * (intra-block fluid-fluid couplings)
#   e_c[I,J] = sum of couplings crossing to block (I, J+1)
#   n_c[I,J] = sum of couplings crossing to block (I+1, J)
#
# (one block-reduce pass per level; no comb trick needed).  Verified
# against dense P^T A P in tests/test_multigrid.py.
#
# Cycle type: the constant prolongation's interpolation order is low, so
# plain V-cycle iteration counts grow slowly with depth (measured PCG
# iters to rel 1e-4 on dam-break-like free-surface geometry: 19 at 256²,
# 23 at 512², 38 at 1024²); the W-CYCLE restores level-independence
# (15 → 15 → 17 on the same systems) at ~1.5x the per-cycle cost and is
# the default for preconditioner="mg" + mg_scheme="galerkin".
# ---------------------------------------------------------------------------


class EdgeLevel(NamedTuple):
    """One level of the Galerkin hierarchy: a symmetric 5-point operator
    in edge-weight form.  Couplings: e[i,j] couples (i,j)<->(i,j+1),
    n[i,j] couples (i,j)<->(i+1,j); the west/south couplings are the
    shifted views of e/n.  Level 0 is the PCG matrix itself
    (main.c:554-575: c = a_diag on fluid, e/n = -1 on fluid-fluid faces).

    `active` (block contains any fluid cell) is implicit in the weights:
    c, e, n are zero at (and toward) inactive cells, and inv_c = 0 there,
    so iterates stay exactly zero outside the active set without masking.
    """

    c: jnp.ndarray      # diagonal
    e: jnp.ndarray      # east coupling
    n: jnp.ndarray      # north coupling
    inv_c: jnp.ndarray  # 1/c where c > 0 else 0
    active: jnp.ndarray  # bool (kept for tests/introspection)
    lmax: jnp.ndarray   # 0-d Gershgorin bound max(c + |row off-diags|)


def _edge_level(c, e, n, active):
    pos = c > 1e-12
    inv_c = jnp.where(active & pos, 1.0, 0.0) / jnp.where(pos, c, 1.0)
    c = jnp.where(active, c, 0)
    # Gershgorin row bound: off-diags are <= 0, so |row sum| is
    # -(e + w + n + s).  NOT the static 8*2^l one might expect: blocks
    # whose fluid cells are only diagonally adjacent lose the intra-block
    # couplings but keep their diagonals, pushing the bound toward
    # 4x/level (measured on random speckle masks); Chebyshev with an
    # UNDER-estimated lmax diverges, so the true bound is computed here.
    offmag = -(e + shift_left(e) + n + shift_down(n))
    lmax = jnp.maximum(jnp.max(jnp.where(active, c + offmag, 0)), 1.0)
    return EdgeLevel(c, e, n, inv_c, active, lmax)


def fine_edge_level(a_diag, fluid, dtype) -> EdgeLevel:
    """The reference operator (apply_a, main.c:679-691) in edge form."""
    fl = fluid
    c = jnp.where(fl, a_diag, 0).astype(dtype)
    e = jnp.where(fl & shift_right(fl), -1.0, 0.0).astype(dtype)
    n = jnp.where(fl & shift_up(fl), -1.0, 0.0).astype(dtype)
    return _edge_level(c, e, n, fl)


def apply_edge(level: EdgeLevel, x):
    """A x for the symmetric edge-weight 5-point operator."""
    return (
        level.c * x
        + level.e * shift_right(x) + shift_left(level.e * x)
        + level.n * shift_up(x) + shift_down(level.n * x)
    )


def _pair_weights(n: int, parity) -> jnp.ndarray:
    """[n, n//2] 0/1 matrix: column j sums fine indices 2j and 2j+1
    (parity=None), or selects index 2j+parity."""
    import numpy as np

    W = np.zeros((n, n // 2), np.float32)
    for j in range(n // 2):
        if parity is None:
            W[2 * j, j] = 1.0
            W[2 * j + 1, j] = 1.0
        else:
            W[2 * j + parity, j] = 1.0
    return jnp.asarray(W)


def _ldot(W, a):
    """[Y, P]^T-contract: sum_y W[y, p] a[y, x] -> [P, X] (exact)."""
    import jax

    return jax.lax.dot_general(
        W.astype(a.dtype), a, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )


def _rdot(a, W):
    import jax

    return jnp.dot(a, W.astype(a.dtype),
                   precision=jax.lax.Precision.HIGHEST)


def coarsen_galerkin(level: EdgeLevel) -> EdgeLevel:
    """A_{l+1} = P^T A_l P for constant prolongation (2x2 blocks).

    The 2x2 block reductions run as matrix products with 0/1
    pair-sum / parity-select matrices.  Precision.HIGHEST keeps them
    exact: every output is a sum of at most two nonzero float32 terms,
    so the result is bitwise equal to a reshape-and-sum (tested), where
    a default-precision product may round through TF32 on a GPU.  The
    reshape form costs O(N²) instead of O(N³); which form is faster on
    the accelerator is ROADMAP Queue 1 item 4."""
    Y, X = level.c.shape
    xs, xe, xo = (_pair_weights(X, None), _pair_weights(X, 0),
                  _pair_weights(X, 1))
    ys, ye, yo = (_pair_weights(Y, None), _pair_weights(Y, 0),
                  _pair_weights(Y, 1))
    # c_c[I,J] = block diagonal sum + 2 * intra-block couplings
    #   intra-x: sum_a e[2I+a, 2J]   (east edges inside the block)
    #   intra-y: sum_b n[2I, 2J+b]   (north edges inside the block)
    c_c = (
        _ldot(ys, _rdot(level.c, xs))
        + 2.0 * _ldot(ys, _rdot(level.e, xe))
        + 2.0 * _ldot(ye, _rdot(level.n, xs))
    )
    e_c = _ldot(ys, _rdot(level.e, xo))   # edges crossing east
    n_c = _ldot(yo, _rdot(level.n, xs))   # edges crossing north
    act = _ldot(ys, _rdot(level.active.astype(level.c.dtype), xs)) > 0
    return _edge_level(c_c, e_c, n_c, act)


def coarsen_galerkin_reshape(level: EdgeLevel) -> EdgeLevel:
    """coarsen_galerkin as reshape-and-sum, with the same association
    (x pairs first, then y pairs): the reference its matrix-product form
    must match bitwise."""
    Y, X = level.c.shape

    def q(a):
        return a.reshape(Y // 2, 2, X // 2, 2)

    def block_sum(a):
        a = q(a)
        return ((a[:, 0, :, 0] + a[:, 0, :, 1])
                + (a[:, 1, :, 0] + a[:, 1, :, 1]))

    e, n = q(level.e), q(level.n)
    c_c = (block_sum(level.c)
           + 2.0 * (e[:, 0, :, 0] + e[:, 1, :, 0])
           + 2.0 * (n[:, 0, :, 0] + n[:, 0, :, 1]))
    e_c = e[:, 0, :, 1] + e[:, 1, :, 1]
    n_c = n[:, 1, :, 0] + n[:, 1, :, 1]
    act = q(level.active).any(axis=(1, 3))
    return _edge_level(c_c, e_c, n_c, act)


def build_galerkin_hierarchy(a_diag, fluid, dtype, min_size: int = 32,
                             max_levels: int = 16):
    """EdgeLevel list, fine to coarse (level 0 = the PCG matrix).
    Odd level sizes are padded with inactive cells before coarsening."""
    levels = [fine_edge_level(a_diag, fluid, dtype)]
    for _ in range(max_levels):
        lv = levels[-1]
        Y, X = lv.c.shape
        if min(Y, X) <= min_size:
            break
        if Y % 2 or X % 2:
            pad = ((0, Y % 2), (0, X % 2))
            lv = EdgeLevel(
                *(jnp.pad(f, pad) for f in
                  (lv.c, lv.e, lv.n, lv.inv_c, lv.active)),
                lv.lmax,
            )
            levels[-1] = lv
        levels.append(coarsen_galerkin(lv))
    return levels


def smooth_edge(level: EdgeLevel, x, b, iters: int, reverse: bool = False):
    """Red-black Gauss-Seidel (exact for 5-point: colours decouple).
    Post-smoothing reverses the colour order so the cycle operator is
    symmetric (required for PCG)."""
    import jax

    red = _checkerboard(x.shape)
    first, second = (~red, red) if reverse else (red, ~red)

    def half(x, mask):
        r = b - apply_edge(level, x)
        return x + jnp.where(mask, r * level.inv_c, 0)

    def body(_, x):
        return half(half(x, first), second)

    return jax.lax.fori_loop(0, iters, body, x, unroll=2)


# ---------------------------------------------------------------------------
# Chebyshev smoothing / coarsest solve.
#
# Motivation: the W-cycle's cost on the tiny coarse levels is per-op
# overhead, not arithmetic, so fewer operator applies per smoothing
# step is what counts there.  A Chebyshev iteration
# needs ONE operator apply per degree (RB-GS needs two per iteration,
# one per colour) and no colour masks, and as a fixed polynomial in A it
# is exactly symmetric without the colour-order reversal — so the cycle
# stays a valid SPD preconditioner by construction.  Measured on 512²
# free-surface systems: deg-2 smoothing + deg-12 coarsest solve brings
# PCG to 10-13 iterations (vs 15 with RB-GS V(1,1) + 32-lap coarsest).
#
# Eigenvalue bound: each EdgeLevel carries its Gershgorin bound
# max(c + |row off-diags|), computed at build time.  (A static 8 * 2^l
# estimate — row sums doubling per level — holds on connected fluid but
# is VIOLATED on speckled masks, where blocks with only diagonally
# adjacent fluid cells push the bound toward 4x/level; an under-estimated
# lmax makes Chebyshev diverge, so the measured bound is used.)
# ---------------------------------------------------------------------------


def cheby_coefficients(lmax, degree: int, ratio: float):
    """Scalar coefficient schedule for the Chebyshev iteration
    (Golub-Varga three-term recurrence) on [lmax/ratio, lmax].

    Returns (inv_theta, [(c_prev_k, c_r_k)]): d_0 = r_0 / theta, then
    d_k = c_prev_k * d_{k-1} + c_r_k * r_k.  `lmax` may be a Python
    float or a traced 0-d array (the per-level Gershgorin bound)."""
    lmin = lmax / ratio
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    coefs = []
    for _ in range(degree):
        rho_new = 1.0 / (2.0 * sigma - rho)
        coefs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return 1.0 / theta, coefs


def cheby_smooth(level: EdgeLevel, x, b, degree: int, ratio: float):
    """`degree` Chebyshev steps targeting the upper spectrum
    [lmax/ratio, lmax] from iterate x (degree+1 operator applies)."""
    inv_theta, coefs = cheby_coefficients(
        level.lmax.astype(b.dtype), degree, ratio
    )
    r = b - apply_edge(level, x)
    d = r * inv_theta
    for c_prev, c_r in coefs:
        x = x + d
        r = r - apply_edge(level, d)
        d = c_prev * d + c_r * r
    return x


def cycle_galerkin(levels, b, lvl: int = 0, pre: int = 1, post: int = 1,
                   coarse_iters: int = 12, w: int = 2,
                   smoother: str = "cheby", cheby_degree: int = 2,
                   cheby_ratio: float = 4.0, coarse_ratio: float = 100.0,
                   w_depth: int = 3):
    """One multigrid cycle on the Galerkin hierarchy.

    w=2 gives the W-cycle, truncated below `w_depth` (levels >= w_depth
    recurse once): the extra visits of the TINY levels cost real kernel
    latency but, measured, do not reduce the PCG iteration count —
    truncating at depth 3 keeps the full-W count.

    smoother="cheby": degree-`cheby_degree` Chebyshev smoothing and a
    degree-`coarse_iters` Chebyshev coarsest solve on [lmax/coarse_ratio,
    lmax]; "rbgs" keeps symmetric red-black Gauss-Seidel (pre/post
    counts, forward-then-reversed coarsest sweeps).

    Padded levels: b is zero-padded on entry and cropped on exit; padded
    cells are inactive (zero weights), so they stay exactly zero."""
    level = levels[lvl]
    Yb, Xb = b.shape
    Yl, Xl = level.c.shape
    if (Yb, Xb) != (Yl, Xl):
        b = jnp.pad(b, ((0, Yl - Yb), (0, Xl - Xb)))
    kw = dict(pre=pre, post=post, coarse_iters=coarse_iters, w=w,
              smoother=smoother, cheby_degree=cheby_degree,
              cheby_ratio=cheby_ratio, coarse_ratio=coarse_ratio,
              w_depth=w_depth)
    if lvl == len(levels) - 1:
        if smoother == "cheby":
            x = cheby_smooth(level, jnp.zeros_like(b), b,
                             coarse_iters, coarse_ratio)
        else:
            x = smooth_edge(level, jnp.zeros_like(b), b, coarse_iters)
            x = smooth_edge(level, x, b, coarse_iters, reverse=True)
        x = jnp.where(level.active, x, 0)
        return x[:Yb, :Xb]
    if smoother == "cheby":
        x = cheby_smooth(level, jnp.zeros_like(b), b,
                         cheby_degree, cheby_ratio)
    else:
        x = smooth_edge(level, jnp.zeros_like(b), b, pre)
    visits = w if (lvl < w_depth and lvl + 1 < len(levels) - 1) else 1
    for _ in range(visits):
        r = b - apply_edge(level, x)
        rc = r.reshape(Yl // 2, 2, Xl // 2, 2).sum(axis=(1, 3))
        ec = cycle_galerkin(levels, rc, lvl + 1, **kw)
        # constant prolongation: each fine cell adds its parent's value
        up = jnp.broadcast_to(
            ec[:, None, :, None], (Yl // 2, 2, Xl // 2, 2)
        ).reshape(Yl, Xl)
        x = x + up
    if smoother == "cheby":
        x = cheby_smooth(level, x, b, cheby_degree, cheby_ratio)
    else:
        x = smooth_edge(level, x, b, post, reverse=True)
    # smoothing keeps inactive cells' iterates at zero, but the
    # prolongation adds parent values everywhere; mask once on exit
    x = jnp.where(level.active, x, 0)
    return x[:Yb, :Xb]


def make_mg_preconditioner(cfg: SimConfig, solid, fluid, dtype, a_diag=None):
    """Returns z = M^{-1} r as a pure function for the PCG loop."""
    if cfg.solver.mg_scheme == "galerkin":
        if a_diag is None:
            s = solid.astype(jnp.int32)
            diag = 4 - (shift_left(s) + shift_right(s)
                        + shift_down(s) + shift_up(s))
            a_diag = jnp.where(fluid, diag, 0)
        levels = build_galerkin_hierarchy(
            a_diag, fluid, dtype, min_size=cfg.solver.mg_min_size
        )
        return partial(
            cycle_galerkin,
            levels,
            pre=cfg.solver.mg_pre_smooth,
            post=cfg.solver.mg_post_smooth,
            coarse_iters=cfg.solver.mg_coarse_iters,
            w=2 if cfg.solver.mg_cycle == "w" else 1,
            smoother=cfg.solver.mg_smoother,
            cheby_degree=cfg.solver.mg_cheby_degree,
            cheby_ratio=cfg.solver.mg_cheby_ratio,
            coarse_ratio=cfg.solver.mg_coarse_ratio,
            w_depth=cfg.solver.mg_w_depth,
        )
    levels = build_hierarchy(solid, fluid, dtype, min_size=cfg.solver.mg_min_size)
    return partial(
        v_cycle,
        levels,
        pre=cfg.solver.mg_pre_smooth,
        post=cfg.solver.mg_post_smooth,
        coarse_iters=cfg.solver.mg_coarse_iters,
    )
