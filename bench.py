#!/usr/bin/env python
"""Benchmark: FCT-ALE step (or stress2rhs call) throughput on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "grid-points/s/card",
   "vs_baseline": F, "device": {...}, "detail": {...}}

The reference publishes no absolute numbers (PERF.md), so ``vs_baseline``
reports the achieved fraction of the card's published memory bandwidth,
computed from the reference-style bytes-moved model (runtime/profiling.py):
the effective-bandwidth method of the reference's kernel_tuner harnesses
(kernels/fct_ale_a1.py:93-95).  The step is timed as a ``lax.scan`` of
``--steps`` steps around ``jax.block_until_ready``, best of 3; compilation
is reported separately as set-up time.  Runs only on a GPU.

Usage: python bench.py [--preset core2] [--steps 100] [--dtype f32]
                       [--iter] [--tracers 4] [--workload stress2rhs]
"""

import argparse
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="core2")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    ap.add_argument("--iter", action="store_true", help="iterative FCT mode")
    ap.add_argument("--workload", default="fct_ale",
                    choices=["fct_ale", "stress2rhs"])
    ap.add_argument("--tracers", type=int, default=1,
                    help="batch Tb tracers through one compiled step "
                    "(reports per-tracer step time)")
    args = ap.parse_args()
    if args.tracers > 1 and args.workload != "fct_ale":
        ap.error("--tracers requires --workload fct_ale")

    import jax

    from fesom2_accelerate_tpu.runtime.compile_cache import (
        enable_compile_cache,
    )
    from fesom2_accelerate_tpu.runtime.device import (
        NoGpuError,
        device_info,
        gpu_name_and_power_limit,
        require_gpu,
    )

    try:
        require_gpu()
    except NoGpuError as e:
        sys.exit(str(e))
    enable_compile_cache()
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields

    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64
    mesh = generate_planar_mesh(preset=args.preset)
    if args.workload == "stress2rhs":
        name, value, unit, model_bytes, dt_s, compile_s = _stress2rhs(
            mesh, args, dtype)
    else:
        name, value, unit, model_bytes, dt_s, compile_s = _fct_ale(
            mesh, args, dtype, random_fields)

    from fesom2_accelerate_tpu.runtime.profiling import hbm_peak_bytes_per_s

    dev = device_info()
    peak = hbm_peak_bytes_per_s(dev["kind"])
    print(json.dumps({
        "metric": name,
        "value": value,
        "unit": unit,
        "vs_baseline": (model_bytes / dt_s) / peak,
        "device": dev,
        "card": gpu_name_and_power_limit(),
        "detail": {
            "ms": dt_s * 1e3,
            "compile_s": compile_s,
            "modeled_GB": model_bytes / 1e9,
            "eff_GBps": model_bytes / dt_s / 1e9,
            "peak_GBps": peak / 1e9,
            "steps": args.steps,
            "tracers": args.tracers,
        },
    }))


def _time_scan(run, state, n_steps):
    """(compile + first run seconds, best-of-3 seconds per step)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(run(state, n_steps))
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(state, n_steps))
        best = min(best, (time.perf_counter() - t0) / n_steps)
    return compile_s, best


def _fct_ale(mesh, args, dtype, random_fields):
    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver
    from fesom2_accelerate_tpu.runtime.profiling import (
        fct_ale_step_bytes,
        grid_points,
    )

    cfg = FctAleConfig(dt=0.5, iter_yn=args.iter, dtype=dtype,
                       flux_eps=1e-16 if args.dtype == "f64" else 1e-7)
    solver = FctAleSolver(mesh, cfg)
    Tb = args.tracers
    if Tb > 1:
        per = [random_fields(mesh, seed=t) for t in range(Tb)]
        fields = {k: per[0][k] for k in ("hnode", "hnode_new")}
        for k in per[0]:
            if k not in fields:
                fields[k] = np.stack([f[k] for f in per])
        state = solver.init_state_tracers(fields)
        run = solver.run_tracers
    else:
        state = solver.init_state(random_fields(mesh, seed=0))
        run = solver.run
    compile_s, dt_s = _time_scan(run, state, args.steps)
    dt_s /= Tb  # per-tracer step time
    itemsize = 4 if args.dtype == "f32" else 8
    name = f"fct_ale_step_{args.preset}_{args.dtype}"
    name += "_iter" if args.iter else ""
    name += f"_T{Tb}" if Tb > 1 else ""
    return (name, grid_points(mesh) / dt_s, "grid-points/s/card",
            fct_ale_step_bytes(mesh, itemsize, iter_yn=args.iter), dt_s,
            compile_s)


def _stress2rhs(mesh, args, dtype):
    """Second workload (reference src/reference.cpp:440-480): the calls run
    as a scan whose carry feeds the next call's ``rhs_a``, like the EVP
    substep loop that calls it ~100 times per timestep."""
    import jax
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.model.stress2rhs import Stress2RhsSolver
    from fesom2_accelerate_tpu.ops import stages
    from fesom2_accelerate_tpu.runtime.profiling import stress2rhs_bytes

    rng = np.random.default_rng(7)
    E, N = mesh.n_elems, mesh.n_nodes
    host = (np.abs(rng.standard_normal(E)) + 0.1, rng.standard_normal(E),
            *rng.standard_normal((3, E)), rng.standard_normal((6, E)),
            rng.standard_normal(E), rng.standard_normal(N),
            *rng.standard_normal((2, N)))
    dargs = [jnp.asarray(a, dtype) for a in host]
    solver = Stress2RhsSolver(mesh, dtype=dtype)
    eps = jnp.asarray(1e-30, dtype)
    elem, rhs_m = dargs[:8], dargs[9]

    # mesh data and inputs are jit arguments (closure-captured arrays would
    # be inlined as HLO constants)
    @jax.jit
    def scan_calls(md, elem, rhs_a, rhs_m):
        def body(ra, _):
            u, _v = stages.stress2rhs(md, *elem, ra, rhs_m)
            return ra + eps * u, None

        out, _ = jax.lax.scan(body, rhs_a, None, length=args.steps)
        return out

    compile_s, dt_s = _time_scan(
        lambda s, n: scan_calls(solver.md, elem, s, rhs_m), dargs[8],
        args.steps)
    itemsize = 4 if args.dtype == "f32" else 8
    return (f"stress2rhs_{args.preset}_{args.dtype}", N / dt_s,
            "nodes/s/card", stress2rhs_bytes(mesh, itemsize), dt_s, compile_s)


if __name__ == "__main__":
    main()
