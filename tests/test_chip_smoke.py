"""chip_smoke.py: its control flow, rehearsed on the CPU at tiny sizes
through the same phase functions (`main` itself refuses the CPU), its
output contract, and — marked `chip` — the phases at full size, which
skip unless the default device is a GPU (`python chip_smoke.py` runs
them on the card)."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chips_option_selects_phases():
    assert cs.phases_for(4) == [cs.phase_device, cs.phase_spatial,
                                cs.phase_data_parallel]
    assert cs.phases_for(1) == [cs.phase_device, cs.phase_cli,
                                cs.phase_parity, cs.phase_gpu_vs_cpu,
                                cs.phase_full_width, cs.phase_largest]


def test_last_line_format():
    line = cs.last_line()
    assert "\n" not in line
    rec = json.loads(line)
    dev = jax.devices()[0]
    assert rec == {"ok": True, "device": {"platform": dev.platform,
                                          "kind": dev.device_kind,
                                          "count": len(jax.devices())}}


def test_rehearse_one_card_phases(capsys):
    """Phases 2-6 in order at tiny sizes (phase 1 is the GPU check)."""
    cs.phase_cli(scenarios=("filter", "weird-edges"), frames=2)
    horizons = cs.phase_parity(max_frames=2, names=("waterfall",))
    assert horizons == {("waterfall", False): None,
                        ("waterfall", True): None}
    r = cs.phase_gpu_vs_cpu(size=32)
    assert r["du"] == r["dv"] == 0.0  # one backend here: bitwise
    assert r["matmul_exact"]
    m = cs.phase_full_width(size=32, frames=2)
    assert m["frames"] == 2 and m["value"] > 0
    cs.phase_largest(size=64)
    out = capsys.readouterr().out
    for tag in ("[2 cli]", "[3 parity]", "[4 cpu vs cpu]", "[5 full width]",
                "[6 largest]"):
        assert tag in out


def test_rehearse_four_card_phases(capsys):
    """The --chips 4 phases on four of the virtual CPU devices."""
    cs.phase_spatial(size=32, frames=1, n=4)
    cs.phase_data_parallel(n=4, frames=1)
    out = capsys.readouterr().out
    assert "(4 in the output sharding)" in out
    assert out.count("[data parallel] instance") == 4


@pytest.mark.chip
def test_one_card_phases_on_chip(gpu):
    for phase in cs.phases_for(1):
        phase()


@pytest.mark.chip
def test_four_card_phases_on_chip(gpu):
    if len(jax.devices()) < 4:
        pytest.skip("needs four GPUs")
    for phase in cs.phases_for(4):
        phase()
