"""Simulation state as immutable pytrees.

The reference keeps all state in fixed-size global C arrays
(/root/reference/main.c:64-100).  Here state is an
immutable pytree so the whole step is a pure `state -> state` function that
jit/vmap/shard_map compose over.

Conventions (identical to the reference):
  * arrays are indexed [y, x];
  * `u` samples live on vertical faces: logical shape [Y, X-1], stored
    [Y, X] with the last column unused (main.c:64 stores [Y][X] too, "so
    functions like bilinear interpolation can work on any array");
  * `v` samples live on horizontal faces: logical [Y-1, X] stored [Y, X];
  * "fluid" means marker_count > 0 (main.c:99 aliases g_fluid to
    g_marker_count).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from euler_tpu.config import SimConfig


def _pytree_dataclass(cls):
    """Frozen dataclass whose every field is a pytree child, with a
    functional `replace(**changes)`."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    cls.replace = replace
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(
        cls, data_fields=names, meta_fields=[]
    )


@_pytree_dataclass
class Scenario:
    """Static per-scenario cell flags (main.c:71-73) and derived indices."""

    solid: jax.Array    # bool [Y, X]
    source: jax.Array   # bool [Y, X]
    sink: jax.Array     # bool [Y, X]
    # Source cell coordinates in update_fluid_sources scan order
    # (y-major ascending, main.c:284-285), shape [S, 2] int32 rows (y, x).
    # S is static per scenario, so jit specialises on it.  The list may be
    # padded (for batching scenarios with different source counts);
    # source_valid masks real entries.
    source_yx: jax.Array
    source_valid: jax.Array  # bool [S]

    @property
    def num_sources(self) -> int:
        return self.source_yx.shape[0]


@_pytree_dataclass
class FluidState:
    """Dynamic simulation state (one scenario instance).

    Mirrors the reference globals: velocities (main.c:64-65), colours
    (main.c:77-82), marker particles (main.c:92-97), the RNG stream
    (main.c:204) and frame counter (main.c:89).
    """

    u: jax.Array               # f32 [Y, X]   (logical [Y, X-1])
    v: jax.Array               # f32 [Y, X]   (logical [Y-1, X])
    r: jax.Array               # f32 [Y, X]
    g: jax.Array               # f32 [Y, X]
    b: jax.Array               # f32 [Y, X]
    # Marker positions, coordinate-major: markers[0] = x, markers[1] = y.
    # [2, M] rather than [M, 2] so each coordinate is one contiguous
    # plane (unit-stride loads for the per-marker arithmetic).
    # In the "slots" layout, flat index m = (k*Y + y)*X + x, i.e. the
    # array views as [2, K, Y, X] with the grid dims minor.
    markers: jax.Array         # f32 [2, M] world-space positions
    alive: jax.Array           # bool [M] marker slot in use
    marker_count: jax.Array    # i32 [Y, X] markers per cell (g_marker_count)
    prev_marker_count: jax.Array  # i32 [Y, X] previous step (g_prev_marker_count)
    alive_count: jax.Array     # i32 scalar (g_markers_length)
    source_exhausted: jax.Array  # bool scalar (main.c:94)
    rng: jax.Array             # u32 [2] xorshift64* state as (hi, lo)
    frame_count: jax.Array     # i32 scalar (g_frame_count)
    # Cumulative markers dropped by the slots layout's per-cell capacity
    # (arrivals beyond slots_per_cell, markers_slots.py).  The reference
    # bounds counts only by its uint8 counter (main.c:92-97), so any
    # nonzero value here marks a semantic deviation — surfaced in the CLI
    # stats and bench JSON, and asserted zero over the golden scenarios.
    # Always 0 in the "global" layout.
    dropped_markers: jax.Array = None  # i32 scalar
    # Last substep's clamped pressure (zeros before any solve).  The
    # reference solves from scratch each substep (main.c:738-741); with
    # cfg.solver.warm_start the MG-PCG paths seed the next solve from
    # this plane (same stopping tolerance — see ops/project.pcg_loop).
    # Carried across frames: a frame boundary is just another substep
    # boundary of the same flow.
    p: jax.Array = None  # f32 [Y, X]

    @property
    def fluid(self) -> jax.Array:
        """bool [Y, X] — cell contains fluid (main.c:99)."""
        return self.marker_count > 0

    @property
    def prev_fluid(self) -> jax.Array:
        return self.prev_marker_count > 0


def zeros_state(cfg: SimConfig, rng_pair: np.ndarray) -> FluidState:
    Y, X = cfg.ny, cfg.nx
    M = cfg.max_markers
    f = jnp.dtype(cfg.dtype)
    return FluidState(
        u=jnp.zeros((Y, X), f),
        v=jnp.zeros((Y, X), f),
        r=jnp.zeros((Y, X), f),
        g=jnp.zeros((Y, X), f),
        b=jnp.zeros((Y, X), f),
        markers=jnp.zeros((2, M), f),
        alive=jnp.zeros((M,), jnp.bool_),
        marker_count=jnp.zeros((Y, X), jnp.int32),
        prev_marker_count=jnp.zeros((Y, X), jnp.int32),
        alive_count=jnp.zeros((), jnp.int32),
        source_exhausted=jnp.zeros((), jnp.bool_),
        rng=jnp.asarray(rng_pair, jnp.uint32),
        frame_count=jnp.zeros((), jnp.int32),
        dropped_markers=jnp.zeros((), jnp.int32),
        p=jnp.zeros((Y, X), f),
    )


# ------------------------------------------------------------------
# Cell-type machinery (main.c:46-50, 119-156)
# ------------------------------------------------------------------
# A U/V face has a property iff either adjacent P cell has it
# (u_property main.c:128-132, v_property main.c:134-138).  On dense
# arrays that is an OR with the +x / +y shifted array.

def shift_up(a: jax.Array, fill=0) -> jax.Array:
    """a[y+1, x] with `fill` beyond the top edge."""
    pad = jnp.full_like(a[:1], fill)
    return jnp.concatenate([a[1:], pad], axis=0)


def shift_down(a: jax.Array, fill=0) -> jax.Array:
    """a[y-1, x] with `fill` beyond the bottom edge."""
    pad = jnp.full_like(a[:1], fill)
    return jnp.concatenate([pad, a[:-1]], axis=0)


def shift_right(a: jax.Array, fill=0) -> jax.Array:
    """a[y, x+1] with `fill` beyond the right edge."""
    pad = jnp.full_like(a[:, :1], fill)
    return jnp.concatenate([a[:, 1:], pad], axis=1)


def shift_left(a: jax.Array, fill=0) -> jax.Array:
    """a[y, x-1] with `fill` beyond the left edge."""
    pad = jnp.full_like(a[:, :1], fill)
    return jnp.concatenate([pad, a[:, :-1]], axis=1)


def u_property(p_value: jax.Array) -> jax.Array:
    """main.c:128-132 — OR of the P cells left/right of each U face."""
    return p_value | shift_right(p_value, False)


def v_property(p_value: jax.Array) -> jax.Array:
    """main.c:134-138 — OR of the P cells below/above each V face."""
    return p_value | shift_up(p_value, False)


def property_of(p_value: jax.Array, celltype: str) -> jax.Array:
    if celltype == "p":
        return p_value
    if celltype == "u":
        return u_property(p_value)
    if celltype == "v":
        return v_property(p_value)
    raise ValueError(celltype)


def valid_region(cfg: SimConfig, celltype: str) -> np.ndarray:
    """bool [Y, X] mask of the logical sample region for a cell type.

    Arrays are stored padded to [Y, X] (main.c:62-67); the padding
    column/row (x = X-1 for U, y = Y-1 for V) is outside the grid.
    """
    m = np.ones((cfg.ny, cfg.nx), dtype=bool)
    if celltype == "u":
        m[:, -1] = False
    elif celltype == "v":
        m[-1, :] = False
    elif celltype != "p":
        raise ValueError(celltype)
    return m


def grid_size(cfg: SimConfig, celltype: str):
    """(size_x, size_y) per main.c:149-156."""
    if celltype == "p":
        return (cfg.nx, cfg.ny)
    if celltype == "u":
        return (cfg.nx - 1, cfg.ny)
    if celltype == "v":
        return (cfg.nx, cfg.ny - 1)
    raise ValueError(celltype)
