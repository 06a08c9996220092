"""Simulation configuration.

The reference hard-codes everything as compile-time constants (grid size
/root/reference/main.c:22-25, physics constants main.c:58-60, frame time
main.c:849, substep cap main.c:851, CFL factor main.c:838, PCG budget
main.c:735-736, marker capacity main.c:92, color periods main.c:83-84).
Here they are all promoted to a frozen, hashable dataclass so that a single
jitted step function can be specialised per configuration (the config is a
static argument: changing it retraces, which matches XLA's compilation
model of static shapes / static control flow).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Preconditioner = Literal["jacobi", "mg", "ic0", "none"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Pressure-projection (PCG) budget.

    Mirrors main.c:735-736 (max 100 iterations, tol 1e-6 on the infinity
    norm of the residual).  The reference preconditions with serial
    incomplete Cholesky (main.c:580-627); the default here is a
    fully-parallel preconditioner, relying on the tolerance-based stopping
    rule for float-level agreement of the converged pressure.
    """

    max_iterations: int = 100
    tol: float = 1e-6
    # Relative stopping tolerance: exit when ||r||_inf <= max(tol,
    # tol_rel * ||b||_inf).  The reference's absolute 1e-6 (main.c:736)
    # presumes double-precision CG (main.c:716); with f32 iterates and
    # ||b|| ~ 1e3-1e4 at 1024²+ an absolute 1e-6 is below representable
    # precision, so every solve burns the full iteration budget without
    # "converging".  0.0 keeps exact reference semantics (the parity
    # configs); the converged mode (cli.py, bench.py) sets 1e-4.
    tol_rel: float = 0.0
    # Warm-start each substep's pressure solve from the previous
    # substep's solution (zero at each frame's first substep): the
    # iteration lever that costs nothing per iteration is the initial
    # guess.  Stopping semantics are unchanged: tol_eff stays anchored
    # to ||b||_inf (main.c:735-767's rule in tol_rel form), so the
    # converged pressure meets exactly the same tolerance as a cold
    # solve.  OFF by default: the reference always starts from zero
    # (main.c:738-741), and the byte-parity configs must match its
    # iterate trajectory class; the benchmark turns it on.
    warm_start: bool = False
    preconditioner: Preconditioner = "jacobi"
    # Multigrid preconditioner knobs (preconditioner="mg"): V(pre,post)
    # damped-Jacobi cycles over 2x-coarsened mask hierarchies down to
    # min_size, with a fixed smoothing solve at the coarsest level.
    mg_min_size: int = 32
    mg_pre_smooth: int = 1
    mg_post_smooth: int = 1
    # Coarsest-level solve budget: Chebyshev degree (mg_smoother="cheby")
    # or forward+reverse RB-GS sweep count ("rbgs").
    mg_coarse_iters: int = 12
    # Smoother for the galerkin scheme: "cheby" (degree-mg_cheby_degree
    # Chebyshev on [lmax/ratio, lmax]; one operator apply per degree, no
    # colour masks, symmetric by construction) or "rbgs" (red-black
    # Gauss-Seidel with symmetric colour order).  Measured (PERF.md):
    # cheby d2/r4 + deg-12 coarsest converges PCG in 10-13 iterations on
    # 512² free-surface systems vs 15 for rbgs V(1,1) + 32-lap coarsest,
    # at fewer (and larger) vector ops per cycle.
    mg_smoother: str = "cheby"
    # Degree 1 (damped Jacobi on the Chebyshev interval) with W-depth 2:
    # measured on real 512² dam-break systems (tol_rel 1e-4), control
    # (d2/wd3) takes 11 PCG iterations, d1 12, wd2 13, at about half the
    # operator applies per iteration.
    mg_cheby_degree: int = 1
    mg_cheby_ratio: float = 4.0
    mg_coarse_ratio: float = 100.0
    # W-recursion depth: levels < mg_w_depth recurse twice (truncated W).
    # The tiny levels' extra visits cost kernel launches without reducing
    # the iteration count (measured).
    mg_w_depth: int = 2
    # Coarse-operator construction:
    #   "rediscretize" — coarsen the masks, rebuild the 5-point operator
    #                    (loses free-surface Dirichlet geometry on coarse
    #                    levels; V-cycle rate ~0.65 at 1024², PERF.md);
    #   "galerkin"     — exact Galerkin P^T A P coarse operators with
    #                    piecewise-constant prolongation (stays 5-point
    #                    in edge-weight form; boundary-exact; the
    #                    measured fix for the rate — ops/multigrid.py).
    mg_scheme: str = "galerkin"
    # Cycle shape for mg_scheme="galerkin": "w" (level-independent
    # iteration counts with constant prolongation — measured 15-17 PCG
    # iters from 256² to 1024²) or "v" (cheaper per cycle, counts grow
    # slowly with depth: 19/23/38 on the same systems).
    mg_cycle: str = "w"
    # float32 is the accelerator choice; float64 (requires jax_enable_x64)
    # reproduces the reference's double-precision CG (main.c:577-578,716).
    dtype: str = "float32"
    # Evaluate the convergence test every `check_every` iterations.  1 is
    # bitwise-closest to the reference loop.  Not yet read by
    # ops/project.pcg_loop (ROADMAP Queue 1 item 3 would use it to cut
    # the while_loop's per-iteration predicate read).
    check_every: int = 1


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full simulation configuration (static under jit)."""

    # Grid size in P cells, including the one-cell border ring of sinks
    # (reference: X=100, Y=40, main.c:22-25).
    nx: int = 100
    ny: int = 40

    # Physics constants (main.c:58-60).
    side_length: float = 1.0   # grid cell size (m)
    density: float = 1.0       # 2D density (kg/m^2)
    gravity: float = -10.0     # acceleration (m/s^2)

    # Stepping (main.c:838, 849-851).
    frame_time: float = 0.1    # simulated seconds per frame
    max_substeps: int = 8      # CFL substep cap per frame
    cfl: float = 0.75          # max cell-widths of motion per substep

    # Marker particles (main.c:92: capacity 4*Y*X).
    markers_per_cell: int = 4

    # Marker storage layout:
    #   "global" — one flat array + alive mask, random-access lookups;
    #              exact reference semantics (unbounded per-cell counts).
    #   "slots"  — markers stored by home cell, `slots_per_cell` each;
    #              every marker op becomes a 3x3 stencil (no gathers),
    #              at the cost of dropping arrivals beyond
    #              slots_per_cell in one cell (counted in
    #              FluidState.dropped_markers).
    marker_layout: str = "global"
    # 16 makes the slot store LOSSLESS on every observed workload: the
    # per-cell maximum under reference semantics (uint8-bounded,
    # main.c:92-97) measured 16 on waterfall and <= 13 elsewhere over 50
    # frames, and 9 on the 256² dam break over 30.  Any residual drop
    # past 16 still lands in the dropped_markers counter.
    #
    # Default stays 8 (the depth the benchmark has always used; K = 16
    # doubles the marker-pass bytes).  Drops at K = 8 are 0 on all golden
    # scenarios and ~0.04% on the 1024² dam break;
    # bench.py --slots-per-cell 16 is the lossless opt-in.
    slots_per_cell: int = 8
    # Replicate the reference's cross-marker dt leak (global layout
    # only): advect_markers mutates its dt parameter on collisions and
    # never resets it between markers (main.c:465-537, `dt -= t_prev`),
    # so one marker's wall hit shortens every later marker's advection
    # in the same call.  Reference semantics — required for long-horizon
    # byte parity (tests/test_ref_binary.py; filter diverged at frame 29
    # without it).  The slots layout marches cell-major and documents
    # per-marker dt as a deviation.
    marker_dt_carry: bool = True

    # Rendering / colour (main.c:83-84).
    rainbow: bool = False
    source_color_period: float = 10.0   # seconds
    initial_color_period: float = 60.0  # grid cells

    # Grid-advection interpolation implementation:
    #   "stencil" — 3x3 shifted-array selects (no gathers;
    #               valid because CFL <= 0.75 keeps backtraces in-window);
    #   "gather"  — generic XLA gathers (reference formulation).
    # Bit-identical results; see tests/test_stencil.py.
    advect_impl: str = "stencil"

    # Marker-collision march: max masked iterations of the DDA loop.
    # With cfl <= 0.75 a particle has at most one x-event and one y-event
    # (a face crossing or a wall hit each) per substep, and a hit zeroes
    # that axis' velocity — so 3 active iterations bound the reference
    # while-loop (main.c:495-533); the 4th is slack for markers sitting
    # exactly on a face (zero-time events, the float fragility the
    # reference notes at main.c:461-463).
    marker_march_iters: int = 4

    solver: SolverConfig = SolverConfig()

    # Compute dtype for grid fields (velocities, colours).  The reference
    # uses float throughout the grid (main.c:64-82).
    dtype: str = "float32"

    @property
    def max_markers(self) -> int:
        # "global": main.c:92 MAX_MARKER_COUNT = 4*Y*X.
        # "slots": one slot array entry per (cell, slot).
        if self.marker_layout == "slots":
            return self.slots_per_cell * self.nx * self.ny
        return self.markers_per_cell * self.nx * self.ny

    @property
    def u_shape(self):
        # U samples live between horizontal P pairs: [Y, X-1] (main.c:34-44)
        return (self.ny, self.nx - 1)

    @property
    def v_shape(self):
        # V samples live between vertical P pairs: [Y-1, X] (main.c:34-44)
        return (self.ny - 1, self.nx)

    @property
    def p_shape(self):
        return (self.ny, self.nx)


DEFAULT_CONFIG = SimConfig()
