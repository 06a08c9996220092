"""Device-mesh sharding: data parallelism over the scenario batch and
spatial (row-block) domain decomposition of the grid.

The reference has no parallelism of any kind (SURVEY.md §2c); this is the
scale-out design:

  * mesh axes ("data", "y", "x"): the batch dimension shards across
    "data" (pure data parallelism — the fluid analogue of DP), grid rows
    shard across "y" and columns across "x" (2D spatial domain
    decomposition — the stencil analogue of tensor/sequence parallelism).
  * shardings are expressed with jax.sharding.NamedSharding and applied
    through jit's in_shardings/out_shardings; XLA's SPMD partitioner
    inserts the halo exchanges for the shifted-array stencils and psums
    for the solver's global reductions.
  * marker arrays shard on "data" only and stay replicated across "y":
    particles move freely across row blocks, so their gathers/scatters
    against y-sharded grids become collective ops XLA plans for us.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from euler_tpu.config import SimConfig
from euler_tpu.core.state import FluidState, Scenario
from euler_tpu.parallel.batch import step_frame_batched


def make_mesh(n_devices: int | None = None, data: int | None = None,
              x: int = 1):
    """Build a ("data", "y", "x") mesh over the first n_devices devices.

    `x` > 1 adds column-block spatial sharding on top of the row blocks
    — full 2D domain decomposition of the grid (the backlog item of
    ROADMAP.md): XLA then exchanges both row and column halos for the
    stencils.  Default x=1 keeps the row-only decomposition.
    """
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    assert n % x == 0, f"{n} devices don't split into x={x} columns"
    spatial = n // x
    if data is None:
        # favour a square-ish split, data-major
        data = 1
        for cand in range(int(np.sqrt(spatial)), 0, -1):
            if spatial % cand == 0:
                data = cand
                break
    y = spatial // data
    mesh_devs = np.array(devs[:n]).reshape(data, y, x)
    return Mesh(mesh_devs, ("data", "y", "x"))


def scenario_sharding(mesh: Mesh) -> Scenario:
    """PartitionSpecs for a batched Scenario ([B, Y, X] grids)."""
    grid = NamedSharding(mesh, P("data", "y", "x"))
    rep = NamedSharding(mesh, P("data"))
    return Scenario(
        solid=grid, source=grid, sink=grid, source_yx=rep, source_valid=rep
    )


def state_sharding(mesh: Mesh) -> FluidState:
    """PartitionSpecs for a batched FluidState."""
    grid = NamedSharding(mesh, P("data", "y", "x"))
    markers = NamedSharding(mesh, P("data"))
    scalar = NamedSharding(mesh, P("data"))
    return FluidState(
        u=grid, v=grid, r=grid, g=grid, b=grid,
        markers=markers, alive=markers,
        marker_count=grid, prev_marker_count=grid,
        alive_count=scalar, source_exhausted=scalar,
        rng=scalar, frame_count=scalar, dropped_markers=scalar,
        p=grid,
    )


def shard_batch(mesh: Mesh, scn: Scenario, state: FluidState):
    """Place a batched scenario/state onto the mesh."""
    scn = jax.device_put(scn, scenario_sharding(mesh))
    state = jax.device_put(state, state_sharding(mesh))
    return scn, state


def make_sharded_step(cfg: SimConfig, mesh: Mesh):
    """Jit one batched frame with explicit input/output shardings.

    XLA GSPMD propagates the shardings through the whole step (stencil
    halo exchange over "y", reductions psum over the mesh) — the
    replacement for hand-written communication.
    """
    return jax.jit(
        partial(step_frame_batched, cfg),
        in_shardings=(scenario_sharding(mesh), state_sharding(mesh)),
        out_shardings=state_sharding(mesh),
    )
