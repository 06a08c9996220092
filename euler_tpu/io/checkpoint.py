"""Checkpoint / resume of the full simulation state.

The reference has no persistence (SURVEY.md §5); here the state pytree
and scenario round-trip losslessly through a single .npz file, so a run
can stop and resume bit-exactly (including the RNG stream position and
source-exhaustion flag).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from euler_tpu.config import SimConfig, SolverConfig
from euler_tpu.core.state import FluidState, Scenario

_STATE_FIELDS = [f.name for f in dataclasses.fields(FluidState)]
_SCN_FIELDS = [f.name for f in dataclasses.fields(Scenario)]


def _cfg_to_json(cfg: SimConfig) -> str:
    d = dataclasses.asdict(cfg)
    return json.dumps(d)


def _known(cls, d: dict) -> dict:
    """The keys of `d` that are fields of `cls`: checkpoints written by
    older versions carry options that no longer exist."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _cfg_from_json(s: str) -> SimConfig:
    d = _known(SimConfig, json.loads(s))
    d["solver"] = SolverConfig(**_known(SolverConfig, d["solver"]))
    return SimConfig(**d)


def save(path: str, cfg: SimConfig, scn: Scenario, state: FluidState) -> None:
    arrays = {}
    for name in _STATE_FIELDS:
        arrays[f"state.{name}"] = np.asarray(getattr(state, name))
    for name in _SCN_FIELDS:
        arrays[f"scn.{name}"] = np.asarray(getattr(scn, name))
    arrays["config_json"] = np.frombuffer(
        _cfg_to_json(cfg).encode(), dtype=np.uint8
    )
    # atomic update: write a sibling temp file and rename over the
    # destination, so a crash mid-save (saves run on a background
    # thread) can never truncate the previous good checkpoint
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load(path: str):
    with np.load(path) as z:
        cfg = _cfg_from_json(bytes(z["config_json"].tobytes()).decode())
        fields = {}
        for n in _STATE_FIELDS:
            key = f"state.{n}"
            if key in z:
                fields[n] = jnp.asarray(z[key])
            elif n == "dropped_markers":
                # checkpoints written before the drop counter existed
                fields[n] = jnp.zeros((), jnp.int32)
            elif n == "p":
                # checkpoints written before the pressure carry existed
                ny, nx = np.asarray(z["state.u"]).shape
                fields[n] = jnp.zeros((ny, nx), jnp.asarray(z["state.u"]).dtype)
            else:
                raise KeyError(key)
        state = FluidState(**fields)
        scn = Scenario(**{n: jnp.asarray(z[f"scn.{n}"]) for n in _SCN_FIELDS})
    return cfg, scn, state
