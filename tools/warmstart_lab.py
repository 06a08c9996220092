"""Warm-start PCG iteration study.

The iteration-count lever that costs nothing per iteration is
WARM-STARTING each substep's solve from
the previous substep's (unclamped) pressure.

Stopping semantics are preserved: tol_eff = max(tol, tol_rel * ||b||)
stays anchored to the RHS norm (main.c:735-767's rule with the tol_rel
form), NOT to the warm initial residual — the converged solution meets
exactly the same tolerance as the cold solve.

This tool replays real dam-break substep sequences through the
production op-by-op path (pure jnp, CPU) and records, for every active
substep, the PCG iteration count of:

  cold        x0 = 0                        (production today)
  warm        x0 = p_prev (fluid-masked)
  warm-scaled x0 = p_prev * dt_prev/dt_cur
  warm-opt    x0 = alpha * p_prev, alpha = <b, A p>/<A p, A p>
              (one extra operator apply + 2 dots)

The state trajectory always advances with the COLD solution, so every
row reflects exactly the systems production would see.

Run: JAX_PLATFORMS=cpu python tools/warmstart_lab.py [--size 256]
     [--frames 6] [--out WARMSTART_LAB.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--out", default="WARMSTART_LAB.jsonl")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from euler_tpu.config import SimConfig, SolverConfig
    from euler_tpu.core.presets import dam_break
    from euler_tpu.ops import project as proj
    from euler_tpu.ops.forces import max_speed_sq
    from euler_tpu.ops.project import _make_preconditioner, apply_a
    from euler_tpu.sim import _dt_from_msq, substep

    cfg = SimConfig(
        nx=args.size, ny=args.size,
        marker_layout="slots",
        solver=SolverConfig(
            max_iterations=100, tol=1e-6, tol_rel=1e-4,
            dtype="float32", preconditioner="mg",
        ),
    )
    scn, state = dam_break(cfg)

    out = open(args.out, "a", buffering=1)

    def emit(row):
        out.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)

    def pcg_x0(b, a_diag, fluid, x0):
        """PCG with initial guess x0 (masked to the fluid); stopping rule
        anchored to ||b|| exactly as pcg_loop's.  Eager/concrete, so the
        iteration count comes back as a Python int."""
        precon = _make_preconditioner(cfg, a_diag, fluid, scn.solid, b.dtype)
        apply_fn = lambda s: apply_a(a_diag, fluid, s)  # noqa: E731
        b_norm = float(jnp.max(jnp.abs(b)))
        tol = max(cfg.solver.tol, cfg.solver.tol_rel * b_norm)
        if b_norm == 0.0:
            return x0 * 0, 0, 0.0
        x0 = jnp.where(fluid, x0, 0).astype(b.dtype)
        p = x0
        r = b - apply_fn(x0)
        if float(jnp.max(jnp.abs(r))) <= tol:
            return p, 0, float(jnp.max(jnp.abs(r)))
        z = precon(r)
        s = z
        sigma = float(jnp.sum(z * r))
        i = 0
        while i < cfg.solver.max_iterations:
            As = apply_fn(s)
            zs = float(jnp.sum(As * s))
            alpha = sigma / (zs if zs != 0 else 1.0)
            p = p + alpha * s
            r = r - alpha * As
            i += 1
            if not (float(jnp.max(jnp.abs(r))) > tol):
                break
            z = precon(r)
            sigma_new = float(jnp.sum(z * r))
            beta = sigma_new / (sigma if sigma != 0 else 1.0)
            s = z + beta * s
            sigma = sigma_new
        return p, i, float(jnp.max(jnp.abs(r)))

    # capture plumbing: patch solve_pressure to record systems and run
    # the warm variants, while returning the production (cold) result
    ctx = {"dt": None, "dt_prev": None, "p_prev": None, "frame": 0,
           "sub": 0}
    orig_solve = proj.solve_pressure

    def patched(cfg_, b, a_diag, fluid, solid=None, x0=None):
        p_cold, it_cold, res_cold = pcg_x0(b, a_diag, fluid, b * 0)
        row = {
            "frame": ctx["frame"], "sub": ctx["sub"],
            "dt": float(ctx["dt"]),
            "b_inf": round(float(jnp.max(jnp.abs(b))), 4),
            "cold": it_cold,
        }
        if ctx["p_prev"] is not None:
            pp = jnp.where(fluid, ctx["p_prev"], 0).astype(b.dtype)
            _, it_w, _ = pcg_x0(b, a_diag, fluid, pp)
            row["warm"] = it_w
            scale = float(ctx["dt_prev"]) / float(ctx["dt"])
            _, it_ws, _ = pcg_x0(b, a_diag, fluid, pp * scale)
            row["warm_scaled"] = it_ws
            Ap = apply_a(a_diag, fluid, pp)
            den = float(jnp.sum(Ap * Ap))
            alpha = float(jnp.sum(b * Ap)) / (den if den != 0 else 1.0)
            _, it_wo, _ = pcg_x0(b, a_diag, fluid, pp * alpha)
            row["warm_opt"] = it_wo
            # clamped carry: the pressure the simulation carries
            # (main.c:773-779's clamp applied)
            _, it_wc, _ = pcg_x0(b, a_diag, fluid, jnp.maximum(pp, 0))
            row["warm_clamped"] = it_wc
            row["alpha"] = round(alpha, 4)
            row["dt_ratio"] = round(scale, 4)
        emit(row)
        ctx["p_prev"] = p_cold  # unclamped, pre-clamp
        ctx["dt_prev"] = ctx["dt"]
        return p_cold, jnp.int32(it_cold), jnp.float32(res_cold)

    proj.solve_pressure = patched
    try:
        f = state.u.dtype
        for frame in range(args.frames):
            ctx["frame"] = frame
            frame_time = float(cfg.frame_time)
            msq = max_speed_sq(cfg, state.u, state.v)
            sub = 0
            while frame_time > 0.0 and sub < cfg.max_substeps:
                dt = _dt_from_msq(cfg, jnp.asarray(msq),
                                  jnp.asarray(frame_time, f))
                ctx["dt"] = float(dt)
                ctx["sub"] = sub
                state, msq, _ = substep(cfg, scn, state, dt)
                frame_time -= float(dt)
                sub += 1
            state = state.replace(frame_count=state.frame_count + 1)
    finally:
        proj.solve_pressure = orig_solve


if __name__ == "__main__":
    main()
