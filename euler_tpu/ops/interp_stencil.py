"""Stencil-select interpolation: the gather-free fast path for grid
advection.

The CFL limit (0.75 cell-widths per substep, main.c:838) guarantees that
every grid-advection backtrace lands within one cell of its site, and the
staggered cross-component offsets are ±0.5 — so the 2x2 interpolation
neighbourhood of interpolate (main.c:337-364) always lies inside the 3x3
window centred on the site.  Instead of XLA gathers (random-access
loads), each corner is a select over 9 shifted copies of the field:
pure elementwise work that XLA fuses into the surrounding arithmetic.

Produces bit-identical results to euler_tpu.ops.interp.interpolate for
in-window sample positions (same clamp, same modf split, same
fraction-snapped bilinear) — asserted by tests/test_stencil.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from euler_tpu.config import SimConfig
from euler_tpu.core.state import grid_size, property_of
from euler_tpu.ops.interp import bilinear


def _shift_stack(a, fill):
    """9 views: S[dy][dx] == a[y + dy - 1, x + dx - 1], `fill` padded."""
    Y, X = a.shape
    p = jnp.pad(a, ((1, 1), (1, 1)), constant_values=fill)
    return [[p[dy : dy + Y, dx : dx + X] for dx in range(3)] for dy in range(3)]


def interpolate_stencil(cfg: SimConfig, q, fluid, idx_x, idx_y, celltype: str):
    """interpolate (main.c:337-364) for per-site sample grids [Y, X] with
    |idx - site| <= 1 in each axis (guaranteed by CFL + the edge clamp).
    """
    size_x, size_y = grid_size(cfg, celltype)
    f = q.dtype
    hi_x = np.nextafter(np.array(size_x - 1, f), np.array(0.0, f))
    hi_y = np.nextafter(np.array(size_y - 1, f), np.array(0.0, f))
    ix = jnp.clip(idx_x.astype(f), 0.0, hi_x)
    iy = jnp.clip(idx_y.astype(f), 0.0, hi_y)

    whole_x = jnp.floor(ix)
    whole_y = jnp.floor(iy)
    frac_x = ix - whole_x
    frac_y = iy - whole_y

    Y, X = q.shape
    # `idx_*` may be per-site [Y, X] (grid advection) or carry leading
    # batch dims, e.g. [K, Y, X] for slot-layout markers (K sample
    # points per home cell): the [Y, X] stacks and site grids broadcast
    # against leading axes, keeping the grid dims minor.
    site_x = jnp.arange(X, dtype=jnp.int32)[None, :]
    site_y = jnp.arange(Y, dtype=jnp.int32)[:, None]
    # offset of the interpolation base from the site: in {-1, 0}
    ox = whole_x.astype(jnp.int32) - site_x
    oy = whole_y.astype(jnp.int32) - site_y
    at_base = ox == 0  # else base is site-1
    at_base_y = oy == 0

    prop = property_of(fluid, celltype)
    Q = _shift_stack(q, 0)
    V = _shift_stack(prop, False)

    def corner(cy, cx):
        """(valid, value) at (base_y + cy, base_x + cx)."""
        # stack row index = oy + cy + 1 in {cy, cy+1}; same for columns
        def pick(S):
            lo = jnp.where(at_base, S[cy][cx + 1], S[cy][cx])
            hi = jnp.where(at_base, S[cy + 1][cx + 1], S[cy + 1][cx])
            return jnp.where(at_base_y, hi, lo)

        return pick(V), pick(Q)

    v00, q00 = corner(0, 0)
    v01, q01 = corner(0, 1)
    v10, q10 = corner(1, 0)
    v11, q11 = corner(1, 1)
    q00 = jnp.where(v00, q00, 0.0)
    q01 = jnp.where(v01, q01, 0.0)
    q10 = jnp.where(v10, q10, 0.0)
    q11 = jnp.where(v11, q11, 0.0)
    return bilinear(q00, q01, q10, q11, frac_x, frac_y, v00, v01, v10, v11)
