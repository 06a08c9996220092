"""On-device downsampling gather for viewing large grids in a terminal.

The reference renders its fixed 100x40 grid 1:1 into the terminal
window (main.c:914-951); grids beyond the window are simply clipped.
At large grids (1024²+) clipping shows a corner of the domain, so this
module pools the interior into terminal-sized blocks ON DEVICE — the
host transfer stays ~5 bytes per *character cell*, not per grid cell.

Pooling semantics per block:
  * glyph  — max marker count (any water in the block shows);
  * class  — solid wins over sink wins over empty (obstacles stay
    visible at any zoom);
  * colour — mean of the water cells' RGB (rainbow mode).

The pooled arrays carry the same 1-cell border ring the full-resolution
frame has, so the unmodified ANSI encoder (ansi.encode_frame, which
reproduces main.c:914-951) renders them directly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from euler_tpu.config import SimConfig
from euler_tpu.core.state import FluidState, Scenario
from euler_tpu.render.ansi import C_EMPTY, C_SINK, C_SOLID, gather_frame


def _pool(a, fy, fx, reduce_fn, pad_value=0):
    """Block-reduce a [iy, ix] plane with ceil padding."""
    iy, ix = a.shape[:2]
    py = (-iy) % fy
    px = (-ix) % fx
    widths = ((0, py), (0, px)) + ((0, 0),) * (a.ndim - 2)
    a = jnp.pad(a, widths, constant_values=pad_value)
    by, bx = (iy + py) // fy, (ix + px) // fx
    a = a.reshape((by, fy, bx, fx) + a.shape[2:])
    return reduce_fn(a, axis=(1, 3))


@partial(jax.jit, static_argnums=(0, 1, 2))
def gather_frame_downsampled(cfg: SimConfig, fy: int, fx: int,
                             scn: Scenario, state: FluidState):
    """Pooled render gather: (glyph, cls, rgb) at 1/fy x 1/fx resolution.

    Output shapes are [by+2, bx+2] (+ border ring), by = ceil((Y-2)/fy).
    """
    count, cls, rgb = gather_frame(cfg, scn, state)
    # interior only: the global border ring is re-added after pooling
    count = count[1:-1, 1:-1]
    cls = cls[1:-1, 1:-1]
    rgb = rgb[1:-1, 1:-1]

    glyph_d = _pool(count, fy, fx, jnp.max)
    any_solid = _pool(cls == C_SOLID, fy, fx, jnp.any)
    any_sink = _pool(cls == C_SINK, fy, fx, jnp.any)
    cls_d = jnp.where(
        any_solid,
        jnp.uint8(C_SOLID),
        jnp.where(any_sink, jnp.uint8(C_SINK), jnp.uint8(C_EMPTY)),
    )

    water = (count > 0)[..., None].astype(jnp.float32)
    rgb_sum = _pool(rgb.astype(jnp.float32) * water, fy, fx, jnp.sum)
    n_water = _pool(water, fy, fx, jnp.sum)
    rgb_d = (rgb_sum / jnp.maximum(n_water, 1.0)).astype(jnp.uint8)

    pad2 = lambda a: jnp.pad(a, ((1, 1), (1, 1)) + ((0, 0),) * (a.ndim - 2))
    return pad2(glyph_d), pad2(cls_d), pad2(rgb_d)


def pick_factors(cfg: SimConfig, window_rows: int, window_cols: int):
    """Smallest (fy, fx) so the interior fits the terminal window."""
    iy, ix = cfg.ny - 2, cfg.nx - 2
    fy = max(1, -(-iy // max(window_rows, 1)))
    fx = max(1, -(-ix // max(window_cols, 1)))
    return fy, fx


def draw_frame_downsampled(cfg, scn, state, window_rows, window_cols) -> bytes:
    """draw_frame for grids larger than the terminal window.

    Pools on device, then encodes through the standard ANSI path with a
    window-sized shim config (the encoder only reads ny/nx).
    """
    from euler_tpu.render.ansi import (
        T_HIDE_CURSOR,
        T_REPOSITION,
        encode_frame,
    )

    fy, fx = pick_factors(cfg, window_rows, window_cols)
    glyph, cls, rgb = gather_frame_downsampled(cfg, fy, fx, scn, state)
    # window-sized shim config: the encoder only reads ny/nx
    small = SimConfig(ny=int(glyph.shape[0]), nx=int(glyph.shape[1]),
                      rainbow=cfg.rainbow)
    body = encode_frame(
        small,
        np.asarray(glyph),
        np.asarray(cls),
        np.asarray(rgb),
        window_rows,
        window_cols,
        cfg.rainbow,
    )
    return T_REPOSITION + body + T_HIDE_CURSOR
