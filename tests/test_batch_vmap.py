"""vmap over the whole frame on the slot layout (parallel/batch.py's
step_frame_batched): each batch member must match the same instance
stepped alone, mono and with sources (the emission scan under vmap)."""

import numpy as np
import pytest

from euler_tpu.config import SimConfig, SolverConfig
from euler_tpu.core.scenario import build_scenario
from euler_tpu.parallel.batch import build_batch, step_frame_batched_jit
from euler_tpu.sim import step_frame_jit

CFG = SimConfig(
    nx=48, ny=32, marker_layout="slots",
    solver=SolverConfig(preconditioner="mg", tol_rel=1e-4, warm_start=True,
                        max_iterations=60),
)

TEXTS = {
    "mono": [b"0000\n0000\n", b"  00\n  00\nXX\n"],
    # sources ("?") emit through the RNG scan; different source counts
    # exercise the padded source lists
    "sources": [b"??\n\n  00\n  00\n", b"?  ?   ?\n 00\nXX  X\n"],
}


@pytest.mark.parametrize("kind", sorted(TEXTS))
def test_vmap_frames_match_per_instance(kind):
    texts = TEXTS[kind]
    scn, st = build_batch(texts, CFG)
    for _ in range(2):
        st = step_frame_batched_jit(CFG, scn, st)

    for i, text in enumerate(texts):
        scn1, st1 = build_scenario(text, CFG)
        for _ in range(2):
            st1 = step_frame_jit(CFG, scn1, st1)
        np.testing.assert_array_equal(np.asarray(st.marker_count[i]),
                                      np.asarray(st1.marker_count))
        np.testing.assert_allclose(np.asarray(st.u[i]), np.asarray(st1.u),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(st.v[i]), np.asarray(st1.v),
                                   atol=1e-6)
        assert int(st.alive_count[i]) == int(st1.alive_count)
        np.testing.assert_array_equal(np.asarray(st.rng[i]),
                                      np.asarray(st1.rng))
    if kind == "sources":
        assert int(np.asarray(st.alive_count).sum()) > 0
