#!/usr/bin/env python
"""f32 N-step error-accumulation study (SURVEY §7 hard part 2).

The step runs in f32 or f64; the correctness anchor is the f64 path.  This
script measures the f32 drift over N iterative-FCT steps and the
sensitivity of b2's Zalesak division to ``flux_eps`` (reference
kernels/fct_ale_b2.cu:10-11 guards near-zero denominators with eps=1e-16 in
f64; the f32 path rescales it).  Output: markdown tables for PERF.md.

Runs on whatever device JAX uses (set JAX_PLATFORMS=cpu for the CPU).

Usage: python scripts/accuracy_study.py [--preset small]
"""

import argparse
import os
import sys

# prefer the installed package (pip install -e .); fall back to the
# checkout layout so a clean clone still runs without an install step
try:  # noqa: SIM105
    import fesom2_accelerate_tpu  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small")
    ap.add_argument("--steps", type=int, nargs="*",
                    default=[1, 5, 10, 25, 50, 100])
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver

    mesh = generate_planar_mesh(preset=args.preset)
    fields = random_fields(mesh, seed=0, dtype=np.float64)

    def relerr(a, b):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))

    def run(dtype, n, eps):
        cfg = FctAleConfig(dt=0.5, iter_yn=True, dtype=dtype, flux_eps=eps)
        solver = FctAleSolver(mesh, cfg)
        state = solver.init_state(fields)
        # step() (n=1) returns the full diagnostics dict incl. fct_plus;
        # run() carries only the state keys through the scan
        return solver.step(state) if n == 1 else solver.run(state, n)

    keys = ("fct_LO", "fct_adf_v", "fct_adf_h")
    print(f"## f32 N-step drift vs f64 (iterative FCT, preset "
          f"{args.preset}: {mesh.n_nodes} nodes x {mesh.n_layers} layers, "
          f"{jax.devices()[0].device_kind})\n")
    print("| N steps | " + " | ".join(f"{k} (f32)" for k in keys) + " |")
    print("|" + "---|" * (1 + len(keys)))
    for n in args.steps:
        ref = run(jnp.float64, n, 1e-16)
        f32 = run(jnp.float32, n, 1e-7)
        row = [f"| {n} "]
        row += [f"| {relerr(f32[k], ref[k]):.2e} " for k in keys]
        print("".join(row) + "|", flush=True)

    print("\n## b2 flux_eps sensitivity (1 step, f32 vs f64 eps=1e-16)\n")
    print("| flux_eps | fct_plus | fct_minus | fct_LO |")
    print("|---|---|---|---|")
    ref = run(jnp.float64, 1, 1e-16)
    for eps in (1e-5, 1e-6, 1e-7, 1e-8, 1e-9):
        f32 = run(jnp.float32, 1, eps)
        print(f"| {eps:.0e} | {relerr(f32['fct_plus'], ref['fct_plus']):.2e}"
              f" | {relerr(f32['fct_minus'], ref['fct_minus']):.2e}"
              f" | {relerr(f32['fct_LO'], ref['fct_LO']):.2e} |",
              flush=True)


if __name__ == "__main__":
    main()
