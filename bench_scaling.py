#!/usr/bin/env python
"""Multi-GPU scaling harness: grid-points/s per card at 1..N subdomains.

One process drives every card of the host.  At every device count the
sharded step (``ShardedFctAleSolver``, ppermute halo exchange) is checked
against the single-card solver (the run fails on mismatch), then timed as a
``lax.scan`` of ``--steps`` steps around ``jax.block_until_ready``.
``--min-efficiency`` turns the per-card efficiency into a hard gate.  Runs
only on GPUs; the CPU rehearsal of the sharded path is
``__graft_entry__.dryrun_multichip``.

Prints one JSON line per device count + a final summary line.
"""

import argparse
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="core2")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--max-devices", type=int, default=0,
                    help="0 = all available")
    ap.add_argument("--min-efficiency", type=float, default=0.0,
                    help="fail below this per-card efficiency at N>=2")
    ap.add_argument("--check-rtol", type=float, default=2e-6,
                    help="sharded-vs-single tolerance (f32 summation order)")
    args = ap.parse_args()

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

    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver
    from fesom2_accelerate_tpu.parallel import ShardedFctAleSolver
    from fesom2_accelerate_tpu.runtime.profiling import grid_points

    mesh = generate_planar_mesh(preset=args.preset)
    fields = random_fields(mesh, seed=0, dtype=np.float64)
    cfg = FctAleConfig(dt=0.5, iter_yn=True, dtype=jnp.float32,
                       flux_eps=1e-7)
    gp = grid_points(mesh)

    devices = jax.devices()
    nmax = args.max_devices or len(devices)
    counts = [n for n in (1, 2, 4, 8) if n <= nmax]

    # single-card reference for the exactness gate (same n_steps)
    ref_solver = FctAleSolver(mesh, cfg)
    ref_state = ref_solver.run(ref_solver.init_state(fields), args.steps)
    ref_lo = np.asarray(ref_state["fct_LO"], np.float64)
    scale = max(np.abs(ref_lo).max(), 1.0)

    base_gps = None
    failures = []
    for n in counts:
        solver = ShardedFctAleSolver(mesh, cfg, devices=devices[:n])
        state = solver.init_state(fields)
        t0 = time.perf_counter()
        out = jax.block_until_ready(solver.run(state, args.steps))
        compile_s = time.perf_counter() - t0
        got = np.asarray(solver.gather_node(out["fct_LO"]), np.float64)
        relerr = float(np.abs(got - ref_lo).max() / scale)
        ok = relerr < args.check_rtol
        if not ok:
            failures.append(f"devices={n}: fct_LO relerr {relerr:.2e}")
        t0 = time.perf_counter()
        jax.block_until_ready(solver.run(state, args.steps))
        dt = (time.perf_counter() - t0) / args.steps
        per_card = gp / dt / n
        if base_gps is None:
            base_gps = per_card
        eff = per_card / base_gps
        if n >= 2 and args.min_efficiency and eff < args.min_efficiency:
            failures.append(f"devices={n}: efficiency {eff:.3f} < "
                            f"{args.min_efficiency}")
        print(json.dumps({
            "metric": f"fct_ale_sharded_{args.preset}_f32_iter",
            "devices": n,
            "value": gp / dt,
            "unit": "grid-points/s",
            "per_card": per_card,
            "efficiency_vs_1": eff,
            "step_ms": dt * 1e3,
            "compile_s": compile_s,
            "exact_vs_single": ok,
            "relerr_vs_single": relerr,
        }), flush=True)

    print(json.dumps({
        "summary": "scaling",
        "preset": args.preset,
        "counts": counts,
        "device": device_info(),
        "card": gpu_name_and_power_limit(),
        "failures": failures,
    }))
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
