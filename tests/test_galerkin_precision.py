"""Galerkin coarsening precision: the 0/1 pair-sum matrix products of
ops/multigrid.coarsen_galerkin run at Precision.HIGHEST, so each output
is an exact sum of at most two nonzero float32 terms — bitwise equal to
the reshape-and-sum form.  Random (non-integer) edge weights make any
reduced-precision product (TF32 on a GPU) visible.  The CPU checks the
arithmetic here; the chip-marked case runs the same comparison on the
card through chip_smoke.py's phase 4."""

import jax
import numpy as np
import pytest

from chip_smoke import random_edge_level
from euler_tpu.ops import multigrid as MG


@pytest.mark.parametrize("shape", [(64, 64), (96, 160), (256, 128)])
def test_matmul_coarsening_bitwise_equals_reshape_sum(shape):
    lv = random_edge_level(*shape)
    got = jax.jit(MG.coarsen_galerkin)(lv)
    ref = jax.jit(MG.coarsen_galerkin_reshape)(lv)
    for field in ("c", "e", "n", "inv_c", "active", "lmax"):
        a, b = np.asarray(getattr(got, field)), np.asarray(getattr(ref, field))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=field)
    # the weights are genuinely non-integer: a TF32 product would round
    assert not np.array_equal(np.asarray(got.c), np.round(np.asarray(got.c)))


@pytest.mark.chip
def test_gpu_matches_cpu(gpu):
    import chip_smoke

    r = chip_smoke.phase_gpu_vs_cpu()
    assert r["matmul_exact"]
