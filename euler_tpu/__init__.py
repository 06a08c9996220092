"""euler_tpu — a JAX/XLA Eulerian liquid simulation
framework with the capabilities of the cgmb/euler reference.

Physics: staggered MAC grid, marker particles, RK1 semi-Lagrangian
advection, gravity, pressure projection by masked preconditioned
conjugate gradient; ASCII/truecolor terminal rendering; scenario files;
batched and mesh-sharded scale-out.
"""

from euler_tpu import models
from euler_tpu.config import DEFAULT_CONFIG, SimConfig, SolverConfig
from euler_tpu.core.scenario import build_scenario, load_scenario
from euler_tpu.core.state import FluidState, Scenario
from euler_tpu.sim import run_frames_jit, step_frame, step_frame_jit

__version__ = "0.1.0"

__all__ = [
    "models",
    "DEFAULT_CONFIG",
    "SimConfig",
    "SolverConfig",
    "FluidState",
    "Scenario",
    "build_scenario",
    "load_scenario",
    "step_frame",
    "step_frame_jit",
    "run_frames_jit",
    "__version__",
]
