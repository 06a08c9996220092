"""One slot-layout marker pass (markers_slots.marker_pass_slots: march +
re-bin) against the exact global layout (ops/markers.py), on the
geometries the slot store has to handle: K = 8 and 16, cells packed to
K and to 12 markers, solids, sources.

The march is the same arithmetic on both layouts (stencil interpolation
is bit-equal to the gather form), so every cell that receives at most K
markers holds bitwise the same positions.  A cell that receives more
keeps K of them, and the rest are counted in dropped_markers.  The
global layout runs with per-marker dt (marker_dt_carry=False), the
semantics the slot layout implements."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from euler_tpu.config import SimConfig, SolverConfig
from euler_tpu.core.presets import dam_break
from euler_tpu.core.scenario import build_scenario
from euler_tpu.ops.markers import get_marker_pass
from euler_tpu.ops.markers_slots import marker_pass_slots, slot_views
from euler_tpu.sim import step_frame_jit

from helpers import read_scenario

DT = jnp.float32(0.035)


def _slot_state(scenario, K, frames):
    if scenario == "dam_break":
        cfg = SimConfig(nx=64, ny=64, marker_layout="slots",
                        slots_per_cell=K,
                        solver=SolverConfig(max_iterations=60))
        scn, st = dam_break(cfg)
    else:
        cfg = SimConfig(marker_layout="slots", slots_per_cell=K)
        scn, st = build_scenario(read_scenario(scenario + ".txt"), cfg)
    for _ in range(frames):
        st = step_frame_jit(cfg, scn, st)
    return cfg, scn, st


def _pack(cfg, st, n):
    """Fill every 4-marker cell to n markers with copies of its first 4,
    each nudged by a few ulps (distinct, still inside the cell)."""
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    px, py, _ = (np.asarray(a).copy() for a in slot_views(cfg, st))
    cnt = np.asarray(st.marker_count).copy()
    full = cnt == 4
    for k in range(4, n):
        for comp in (px, py):
            src = comp[k % 4]
            bump = np.nextafter(src, src + np.float32(1 + k))
            comp[k] = np.where(full, bump, comp[k])
    cnt = np.where(full, n, cnt)
    valid = np.arange(K)[:, None, None] < cnt[None]
    return st.replace(
        markers=jnp.asarray(np.stack([px.reshape(-1), py.reshape(-1)])),
        alive=jnp.asarray(valid.reshape(-1)),
        marker_count=jnp.asarray(cnt),
        alive_count=jnp.asarray(int(cnt.sum()), jnp.int32),
    )


def _to_global(cfg, st):
    """The same markers in the global layout (order is irrelevant: the
    pass is compared per cell)."""
    gcfg = dataclasses.replace(cfg, marker_layout="global",
                               marker_dt_carry=False)
    px, py, valid = (np.asarray(a) for a in slot_views(cfg, st))
    pos = np.stack([px[valid], py[valid]])
    M = px.size
    markers = np.zeros((2, M), np.float32)
    markers[:, : pos.shape[1]] = pos
    alive = np.zeros((M,), bool)
    alive[: pos.shape[1]] = True
    return gcfg, st.replace(markers=jnp.asarray(markers),
                            alive=jnp.asarray(alive))


def _cell_positions(markers, alive, Y, X):
    m = np.asarray(markers).reshape(2, -1).T[np.asarray(alive).reshape(-1)]
    cell = np.floor(m[:, 1]).astype(int) * X + np.floor(m[:, 0]).astype(int)
    order = np.lexsort((m[:, 1], m[:, 0], cell))
    return cell[order], m[order]


CASES = {
    # (scenario, K, pack cells to n markers, frames of development)
    "dam_k8": ("dam_break", 8, None, 3),
    "dam_k16": ("dam_break", 16, None, 3),
    "dam_packed_to_k8": ("dam_break", 8, 8, 2),
    "dam_packed_to_k16": ("dam_break", 16, 16, 2),
    "dam_packed_to_12_k16": ("dam_break", 16, 12, 2),
    "block_solids_k8": ("block", 8, None, 4),
    "filter_solids_k16": ("filter", 16, None, 4),
    "waterfall_sources_k8": ("waterfall", 8, None, 6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slot_pass_matches_global_until_capacity(case):
    scenario, K, pack, frames = CASES[case]
    cfg, scn, st = _slot_state(scenario, K, frames)
    if pack:
        st = _pack(cfg, st, pack)
    gcfg, gst = _to_global(cfg, st)
    Y, X = cfg.ny, cfg.nx

    out_s = marker_pass_slots(cfg, scn, st, DT)
    out_g = get_marker_pass(gcfg)(gcfg, scn, gst, DT)

    cnt_g = np.asarray(out_g.marker_count)
    cnt_s = np.asarray(out_s.marker_count)
    assert int(cnt_s.sum()) > 0
    # capacity: a cell keeps min(arrivals, K); the excess is counted
    np.testing.assert_array_equal(cnt_s, np.minimum(cnt_g, K))
    dropped = int(out_s.dropped_markers) - int(st.dropped_markers)
    assert dropped == int(np.maximum(cnt_g - K, 0).sum())
    if pack == K:
        assert dropped > 0, "packed cells must overflow somewhere"
    elif pack is None:
        assert dropped == 0, "test premise: no cell exceeds K"

    # bitwise positions in every cell within capacity
    ok_cells = np.flatnonzero((cnt_g <= K).reshape(-1))
    cell_g, pos_g = _cell_positions(out_g.markers, out_g.alive, Y, X)
    cell_s, pos_s = _cell_positions(out_s.markers, out_s.alive, Y, X)
    keep_g = np.isin(cell_g, ok_cells)
    keep_s = np.isin(cell_s, ok_cells)
    np.testing.assert_array_equal(cell_s[keep_s], cell_g[keep_g])
    np.testing.assert_array_equal(pos_s[keep_s], pos_g[keep_g])
    # front-compacted store: slot k is live iff k < count
    valid = np.asarray(out_s.alive).reshape(K, Y, X)
    np.testing.assert_array_equal(
        valid, np.arange(K)[:, None, None] < cnt_s[None])
