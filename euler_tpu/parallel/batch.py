"""Batched multi-scenario simulation via vmap.

The reference is strictly one scenario per process; batching is new
capability (SURVEY.md §2c): a leading batch dimension over independent
scenario instances, mapped with jax.vmap so the whole frame — including
the PCG while_loop and the emission scan — executes as one batched XLA
program.  Combine with euler_tpu.parallel.mesh for data-parallel
placement of the batch across chips.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import numpy as np

from euler_tpu.config import SimConfig
from euler_tpu.core.scenario import build_scenario
from euler_tpu.core.state import FluidState, Scenario
from euler_tpu.sim import step_frame


def build_batch(texts: Sequence[bytes | str], cfg: SimConfig):
    """Build a batched (Scenario, FluidState) from scenario texts.

    Source lists are padded to the max source count across the batch so
    the pytrees stack; source_valid masks the padding.
    """
    from euler_tpu.core.scenario import parse_scenario_text

    max_sources = 0
    for t in texts:
        _, _, source, _ = parse_scenario_text(t, cfg)
        max_sources = max(max_sources, int(source.sum()))

    scns, states = [], []
    for t in texts:
        scn, st = build_scenario(t, cfg, pad_sources=max_sources)
        scns.append(scn)
        states.append(st)

    stack = lambda *xs: jax.numpy.stack(xs)
    return (
        jax.tree.map(stack, *scns),
        jax.tree.map(stack, *states),
    )


def step_frame_batched(cfg: SimConfig, scn: Scenario, state: FluidState):
    """One frame over a leading batch dimension."""
    return jax.vmap(partial(step_frame, cfg))(scn, state)


@partial(jax.jit, static_argnums=0)
def step_frame_batched_jit(cfg, scn, state):
    return step_frame_batched(cfg, scn, state)


def run_frames_batched(cfg: SimConfig, scn, state, n: int):
    def body(state, _):
        return step_frame_batched(cfg, scn, state), None

    state, _ = jax.lax.scan(body, state, None, length=n)
    return state


@partial(jax.jit, static_argnums=(0, 3))
def run_frames_batched_jit(cfg, scn, state, n: int):
    return run_frames_batched(cfg, scn, state, n)


class HostBatchRunner:
    """Host-level data parallelism over independent scenario instances:
    one compiled PER-INSTANCE frame program, dispatched round-robin so
    the device pipelines B instances back to back (bench.py --batch).

    The other batch path is step_frame_batched above, one vmapped
    program over a leading batch axis; which of the two is faster on
    one card is ROADMAP Queue 2 item 6."""

    def __init__(self, cfg: SimConfig, pairs, spatial: bool | None = None):
        """pairs: list of (Scenario, FluidState).  spatial: convert slot
        stores to the [2, K, Y, X] spatial planes (defaults to True for
        the slots layout)."""
        from euler_tpu.sim import step_frame_jit

        if spatial is None:
            spatial = cfg.marker_layout == "slots"
        if spatial:
            from euler_tpu.parallel.spatial import to_spatial

            pairs = [(scn, to_spatial(cfg, st)) for scn, st in pairs]
        self.cfg = cfg
        self.scns = [p[0] for p in pairs]
        self.states = [p[1] for p in pairs]
        self._step = step_frame_jit

    def run(self, n_frames: int):
        """Advance every instance n_frames; returns the states."""
        for _ in range(n_frames):
            self.states = [
                self._step(self.cfg, scn, st)
                for scn, st in zip(self.scns, self.states)
            ]
        return self.states

    def sync(self):
        """Block until every instance's work is done."""
        return jax.block_until_ready(self.states)
