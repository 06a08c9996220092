"""Spatially-sharded full step (markers included) vs the unsharded run.

VERDICT round-1 gap: marker arrays were replicated across the spatial
mesh axes.  euler_tpu.parallel.spatial block-shards the slot marker
planes over ("y", "x"); these tests pin the sharded program against the
single-device one on the 8-device virtual CPU mesh.
"""

import jax
import numpy as np
import pytest

from euler_tpu.config import SimConfig, SolverConfig
from euler_tpu.core.scenario import build_scenario
from euler_tpu.parallel.spatial import (
    make_spatial_step,
    shard_spatial,
    spatial_mesh,
    spatial_state_sharding,
    to_flat,
    to_spatial,
)
from euler_tpu.sim import step_frame_jit

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

CFG = SimConfig(
    nx=32,
    ny=16,
    marker_layout="slots",
    max_substeps=2,
    solver=SolverConfig(max_iterations=30),
)
# solids + a source: exercises collision, re-binning and emission
TEXT = b"?  00\n   00\nX  00\nXX 00\n"


def test_plane_layout_matches_flat():
    """The [2, K, Y, X] marker store must be bit-identical to the flat
    [2, M] store on a single device (same trace, different leaf view)."""
    scn, st = build_scenario(TEXT, CFG)
    flat = step_frame_jit(CFG, scn, st)
    spatial = step_frame_jit(CFG, scn, to_spatial(CFG, st))
    assert spatial.markers.ndim == 4
    back = to_flat(CFG, spatial)
    np.testing.assert_array_equal(np.asarray(back.markers),
                                  np.asarray(flat.markers))
    np.testing.assert_array_equal(np.asarray(back.alive),
                                  np.asarray(flat.alive))
    np.testing.assert_array_equal(np.asarray(back.marker_count),
                                  np.asarray(flat.marker_count))
    np.testing.assert_array_equal(np.asarray(back.rng), np.asarray(flat.rng))


def test_spatial_sharded_matches_unsharded():
    """Full frames on a 4x2 ("y", "x") mesh with marker planes sharded
    P(None, None, "y", "x") match the single-device run."""
    mesh = spatial_mesh(8, x=2)
    assert mesh.devices.shape == (4, 2)

    scn, st = build_scenario(TEXT, CFG)
    ref = st
    for _ in range(3):
        ref = step_frame_jit(CFG, scn, ref)

    scn_s, st_s = shard_spatial(CFG, mesh, scn, st)
    step = make_spatial_step(CFG, mesh)
    got = st_s
    for _ in range(3):
        got = step(scn_s, got)

    # the marker store really is distributed (not replicated)
    mshard = got.markers.sharding
    assert mshard.is_equivalent_to(
        spatial_state_sharding(mesh).markers, got.markers.ndim
    )

    got = to_flat(CFG, got)
    np.testing.assert_array_equal(
        np.asarray(got.marker_count), np.asarray(ref.marker_count)
    )
    np.testing.assert_array_equal(
        np.asarray(got.alive), np.asarray(ref.alive)
    )
    np.testing.assert_allclose(
        np.asarray(got.markers), np.asarray(ref.markers), atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.v), np.asarray(ref.v), atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(got.rng), np.asarray(ref.rng)
    )
    assert int(got.alive_count) == int(ref.alive_count)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_spatial_step_converged_mode(n):
    """The converged mode (Galerkin MG-PCG, warm start) sharded over n
    devices on the mesh shape spatial_mesh picks, against one device:
    same marker counts; velocities to the solve's float32 tolerance (the
    sharded reductions sum in another order)."""
    from euler_tpu.core.presets import dam_break

    cfg = SimConfig(nx=64, ny=64, marker_layout="slots", max_substeps=4,
                    solver=SolverConfig(preconditioner="mg", tol_rel=1e-4,
                                        warm_start=True, max_iterations=60))
    scn, st = dam_break(cfg)
    ref = to_spatial(cfg, st)
    for _ in range(2):
        ref = step_frame_jit(cfg, scn, ref)

    mesh = spatial_mesh(n)
    scn_s, got = shard_spatial(cfg, mesh, scn, st)
    step = make_spatial_step(cfg, mesh)
    for _ in range(2):
        got = step(scn_s, got)
    assert len(got.u.sharding.device_set) == n
    assert len(got.markers.sharding.device_set) == n

    np.testing.assert_array_equal(np.asarray(got.marker_count),
                                  np.asarray(ref.marker_count))
    scale = float(np.abs(np.asarray(ref.u)).max())
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u),
                               atol=5e-4 * scale)
    np.testing.assert_allclose(np.asarray(got.v), np.asarray(ref.v),
                               atol=5e-4 * scale)
    assert int(got.dropped_markers) == int(ref.dropped_markers)
