"""Checkpoint round-trip: resume must be bit-exact."""

import os

import numpy as np

from euler_tpu.config import SimConfig
from euler_tpu.core.scenario import build_scenario
from euler_tpu.io import checkpoint
from euler_tpu.sim import step_frame_jit

from helpers import read_scenario


def test_npz_roundtrip_resume_bitexact(tmp_path):
    cfg = SimConfig()
    scn, st = build_scenario(read_scenario("waterfall.txt"), cfg)
    for _ in range(2):
        st = step_frame_jit(cfg, scn, st)

    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, cfg, scn, st)
    cfg2, scn2, st2 = checkpoint.load(path)

    assert cfg2 == cfg
    for name in ("u", "v", "markers", "marker_count", "rng"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st, name)), np.asarray(getattr(st2, name))
        )

    # continue both one frame: identical trajectories
    a = step_frame_jit(cfg, scn, st)
    b = step_frame_jit(cfg2, scn2, st2)
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))
    np.testing.assert_array_equal(np.asarray(a.markers), np.asarray(b.markers))
    np.testing.assert_array_equal(np.asarray(a.rng), np.asarray(b.rng))


def test_cli_checkpoint_and_resume(tmp_path):
    """Headless CLI writes periodic checkpoints; --load resumes from one.

    Resuming from the checkpoint of frame N must reproduce the straight
    run's state at frame N+K bit-exactly (an extension; the reference
    has no persistence, SURVEY.md §5).
    """
    import subprocess
    import sys

    path = str(tmp_path / "cli_ckpt.npz")
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    run = [sys.executable, "-m", "euler_tpu", "--cpu", "--frames"]
    subprocess.run(
        run + ["4", "scenarios/basic.txt", "--checkpoint", path,
               "--checkpoint-every", "2"],
        check=True, env=env, cwd=os.getcwd(), capture_output=True,
    )
    cfg, scn, st = checkpoint.load(path)
    assert int(st.frame_count) == 4  # exactly the requested frames

    # straight run to frame 6 vs resume for 2 more frames
    for _ in range(2):
        st = step_frame_jit(cfg, scn, st)

    cfg2 = SimConfig()
    scn2, st2 = build_scenario(read_scenario("basic.txt"), cfg2)
    for _ in range(6):
        st2 = step_frame_jit(cfg2, scn2, st2)
    np.testing.assert_array_equal(np.asarray(st.u), np.asarray(st2.u))
    np.testing.assert_array_equal(
        np.asarray(st.marker_count), np.asarray(st2.marker_count)
    )


def test_checkpoint_with_removed_options_loads(tmp_path):
    """Checkpoints written before the kernel options were removed carry
    their keys in config_json; loading skips them."""
    import json

    cfg = SimConfig()
    scn, st = build_scenario(read_scenario("basic.txt"), cfg)
    path = str(tmp_path / "old.npz")
    checkpoint.save(path, cfg, scn, st)
    with np.load(path) as z:
        arrays = dict(z)
    old = json.loads(arrays["config_json"].tobytes().decode())
    old.update(marker_tile=[128, 512], use_pallas_markers=True,
               fuse_marker_pass=True, marker_padded_store=False,
               use_pallas_grid=False, pallas_interpret=False)
    old["solver"].update(use_pallas=True, fuse_projection=True,
                         pallas_interpret=False, mg_frame_hierarchy=False)
    arrays["config_json"] = np.frombuffer(json.dumps(old).encode(), np.uint8)
    np.savez(path, **arrays)

    cfg2, scn2, st2 = checkpoint.load(path)
    assert cfg2 == cfg
    np.testing.assert_array_equal(np.asarray(st2.markers),
                                  np.asarray(st.markers))
