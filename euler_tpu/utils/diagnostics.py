"""Debug and observability utilities.

The reference's equivalents:
  * debug-inl.h:18-85 — Octave-format dumps of the pressure matrix and
    grids (bit-rotted there; functional here, SURVEY.md §2 #25);
  * SHERLOCK build option / enable_fpmath_asserts (misc/debug.c:4-10) —
    trap-on-NaN, mapped to jax_debug_nans;
  * no profiling beyond frame pacing — here the device trace is taken
    by tools/profile_step.py and the timing by bench.py.
"""

from __future__ import annotations

import io

import numpy as np

from euler_tpu.config import SimConfig
from euler_tpu.ops.project import pressure_matrix_diag


def enable_fpmath_asserts() -> None:
    """SHERLOCK equivalent: raise on NaNs produced under jit
    (misc/debug.c:4-10 traps FE_INVALID etc.)."""
    import jax

    jax.config.update("jax_debug_nans", True)


def dump_octave_matrix(name: str, m, out=None) -> str:
    """Octave text format, as debug-inl.h:18-30 intended."""
    m = np.asarray(m)
    buf = out or io.StringIO()
    buf.write(f"# name: {name}\n# type: matrix\n")
    buf.write(f"# rows: {m.shape[0]}\n# columns: {m.shape[1]}\n")
    for row in m:
        buf.write(" " + " ".join(repr(float(v)) for v in row) + "\n")
    return buf.getvalue() if out is None else ""


def dump_pressure_system(cfg: SimConfig, scn, state, dt) -> str:
    """Dump the Poisson system (A diagonal, fluid mask, RHS) for offline
    inspection — the working replacement for debug-inl.h:33-70."""
    import jax.numpy as jnp

    from euler_tpu.ops.project import divergence_rhs

    fluid = state.fluid
    a = pressure_matrix_diag(cfg, scn.solid, fluid)
    b = divergence_rhs(cfg, state.u, state.v, fluid, jnp.asarray(dt))
    out = io.StringIO()
    dump_octave_matrix("a_diag", a, out)
    dump_octave_matrix("fluid", np.asarray(fluid).astype(np.int32), out)
    dump_octave_matrix("b", b, out)
    return out.getvalue()
