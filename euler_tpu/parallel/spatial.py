"""Spatial domain decomposition of the FULL step, markers included.

The reference is single-threaded C with one fixed 100x40 grid
(/root/reference/main.c:22-25); scale-out is new capability
(SURVEY.md §2c).  euler_tpu.parallel.mesh shards the grid fields over a
("data", "y", "x") mesh but keeps marker arrays replicated across the
spatial axes — fine for batch scale-out, useless for one huge grid.

This module shards the marker store itself.  In the slot layout markers
live one-per-(cell, slot), so storing them as spatial planes
[2, K, Y, X] (positions) + [K, Y, X] (validity) makes the grid dims
real array axes that block-shard over ("y", "x") exactly like u/v:

  * the march reads grids/solids only in the 3x3 window of a marker's
    home cell (CFL <= 0.75), so XLA's SPMD partitioner serves it with
    1-cell halo exchanges (collective-permutes between devices);
  * re-binning moves markers at most one cell, i.e. one halo exchange of
    the position planes per neighbour direction;
  * source emission is a scatter at S source cells (replicated indices —
    negligible traffic);
  * the PCG reductions become psums over the mesh.

Everything is expressed with NamedSharding + jit (GSPMD): XLA plans the
collectives; no hand-written communication.  Pinned against the
single-device run in tests/test_spatial.py on the virtual CPU mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from euler_tpu.config import SimConfig
from euler_tpu.core.state import FluidState, Scenario
from euler_tpu.sim import step_frame


def to_spatial(cfg: SimConfig, state: FluidState) -> FluidState:
    """Re-view flat [2, M] slot markers as spatial planes [2, K, Y, X]."""
    assert cfg.marker_layout == "slots", "spatial sharding needs slot markers"
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    if state.markers.ndim == 4:
        return state
    return state.replace(
        markers=state.markers.reshape(2, K, Y, X),
        alive=state.alive.reshape(K, Y, X),
    )


def to_flat(cfg: SimConfig, state: FluidState) -> FluidState:
    """Inverse of to_spatial (checkpoint/CLI-compatible flat layout)."""
    if state.markers.ndim != 4:
        return state
    M = cfg.max_markers
    return state.replace(
        markers=state.markers.reshape(2, M),
        alive=state.alive.reshape(M),
    )


def spatial_mesh(n_devices: int | None = None, x: int | None = None) -> Mesh:
    """A ("y", "x") mesh over the first n_devices devices (square-ish)."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if x is None:
        x = 1
        for cand in range(int(n**0.5), 0, -1):
            if n % cand == 0:
                x = cand
                break
    assert n % x == 0
    import numpy as np

    return Mesh(np.array(devs[:n]).reshape(n // x, x), ("y", "x"))


def spatial_scenario_sharding(mesh: Mesh) -> Scenario:
    grid = NamedSharding(mesh, P("y", "x"))
    rep = NamedSharding(mesh, P())
    return Scenario(
        solid=grid, source=grid, sink=grid, source_yx=rep, source_valid=rep
    )


def spatial_state_sharding(mesh: Mesh) -> FluidState:
    """Shardings for a spatial-plane FluidState: every [*, Y, X] trailing
    pair block-shards over ("y", "x"); scalars replicate."""
    grid = NamedSharding(mesh, P("y", "x"))
    planes = NamedSharding(mesh, P(None, None, "y", "x"))  # [2, K, Y, X]
    valid = NamedSharding(mesh, P(None, "y", "x"))         # [K, Y, X]
    rep = NamedSharding(mesh, P())
    return FluidState(
        u=grid, v=grid, r=grid, g=grid, b=grid,
        markers=planes, alive=valid,
        marker_count=grid, prev_marker_count=grid,
        alive_count=rep, source_exhausted=rep, rng=rep, frame_count=rep,
        dropped_markers=rep, p=grid,
    )


def shard_spatial(cfg: SimConfig, mesh: Mesh, scn: Scenario,
                  state: FluidState):
    """Place one (unbatched) scenario/state onto the spatial mesh."""
    state = to_spatial(cfg, state)
    scn = jax.device_put(scn, spatial_scenario_sharding(mesh))
    state = jax.device_put(state, spatial_state_sharding(mesh))
    return scn, state


def make_spatial_step(cfg: SimConfig, mesh: Mesh):
    """Jit one frame of the FULL pipeline with every field — marker
    planes included — block-sharded over the ("y", "x") mesh."""
    return jax.jit(
        partial(step_frame, cfg),
        in_shardings=(spatial_scenario_sharding(mesh),
                      spatial_state_sharding(mesh)),
        out_shardings=spatial_state_sharding(mesh),
    )
