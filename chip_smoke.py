#!/usr/bin/env python
"""Smoke test of the production path on one NVIDIA GPU.

Drives the FCT-ALE solver (f32 and f64, iterative and not, vlimit 1/2/3),
tracer batching, ``stress2rhs`` and the host ABI through their public entry
points at the CORE2 preset (127,260 nodes x 48 levels), and checks each
against the float64 numpy oracle or the single-tracer path at a stated
tolerance.  Every phase prints its own lines; any failure ends the run with
a nonzero exit code.  The last line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

It refuses to run (exit code 1, no result) when JAX finds no GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # only the 4-card sharded path
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# f32 vs f64: max|d| / max(max|ref|, 1), as tests/test_stages_xla.py
F32_BOUND = 5e-5
F32_SAME = 2e-6  # two f32 computations of one step, summed in other orders
PHYSICAL = ("fct_adf_v", "fct_adf_h", "del_ttf_advvert", "del_ttf_advhoriz")


def say(*parts) -> None:
    print(*parts, flush=True)


def check_close(name, got, ref, rtol=1e-12, atol=1e-12) -> None:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    bad = err > atol + rtol * np.abs(ref)
    say(f"  {name}: max|d|={err.max():.3e} (rtol {rtol:g}, atol {atol:g}) "
        f"{'FAIL' if bad.any() else 'ok'}")
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} of {bad.size} "
                             f"entries outside rtol {rtol} atol {atol}")


def check_scaled(name, got, ref, bound) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    rel = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0))
    tag = "bitwise" if np.array_equal(got, ref) else ""
    say(f"  {name}: max|d|/max(|ref|,1)={rel:.3e} (bound {bound:g}) "
        f"{'ok' if rel < bound else 'FAIL'} {tag}".rstrip())
    if not rel < bound:
        raise AssertionError(f"{name}: scaled error {rel:.3e} >= {bound}")
    return rel


def timed(fn, *args):
    """(result, seconds) of one call that ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def step_ms(run, state, n=20, reps=3) -> float:
    """Best-of-``reps`` milliseconds per step of an ``n``-step scan (the
    scan is compiled and run once before the timed runs)."""
    import jax

    jax.block_until_ready(run(state, n))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(state, n))
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e3


# ---- phases -----------------------------------------------------------------


def phase_device(count: int) -> dict:
    import jax

    from fesom2_accelerate_tpu.runtime.device import (
        device_info,
        gpu_name_and_power_limit,
        require_gpu,
    )

    require_gpu()
    info = device_info()
    say(f"[device] jax {jax.__version__}; {info['kind']}; "
        f"{info['count']} device(s)")
    if info["count"] < count:
        raise AssertionError(f"need {count} GPUs, JAX sees {info['count']}")
    say("[device] nvidia-smi --query-gpu=name,power.limit:")
    say(gpu_name_and_power_limit())
    return info


def phase_f64_oracle(mesh, fields, setup_s: dict) -> dict:
    """One f64 step vs the oracle (vlimit 1, iterative and not), then 5
    scanned iterative steps.  Returns the non-iterative oracle output."""
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver
    from fesom2_accelerate_tpu.ops import oracle

    say(f"[f64 vs oracle] {mesh.n_nodes} nodes x {mesh.n_layers} layers")
    mk = oracle.masks(mesh)
    refs = {}
    for iter_yn in (False, True):
        cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=jnp.float64)
        solver = FctAleSolver(mesh, cfg)
        state = solver.init_state(fields)
        out, s = timed(solver.step, state)
        setup_s[f"step f64 iter={iter_yn}"] = s
        ref = oracle.fct_ale_step(mesh, fields, vlimit=1, iter_yn=iter_yn,
                                  dt=0.7, mk=mk)
        for k, v in ref.items():
            check_close(f"iter={iter_yn} {k}", out[k], v)
        refs[iter_yn] = ref

    n = 5
    cfg = FctAleConfig(dt=0.3, iter_yn=True, dtype=jnp.float64)
    solver = FctAleSolver(mesh, cfg)
    state, s = timed(solver.run, solver.init_state(fields), n)
    setup_s[f"run({n}) f64 iter=True"] = s
    ref = {k: v.copy() for k, v in fields.items()}
    for _ in range(n):
        o = oracle.fct_ale_step(mesh, ref, vlimit=1, iter_yn=True, dt=0.3,
                                mk=mk)
        ref.update(fct_LO=o["fct_LO"], fct_adf_v=o["fct_adf_v"],
                   fct_adf_h=o["fct_adf_h"])
    for k in ("fct_LO", "fct_adf_v", "fct_adf_h"):
        check_close(f"{n} scanned steps {k}", state[k], ref[k], rtol=1e-10,
                    atol=1e-11)
    return refs[False]


def phase_f32(mesh, fields, ref64: dict, setup_s: dict) -> None:
    """f32 step vs the f64 oracle on the physical outputs (limiter factors
    may switch at thresholds, so they are not compared elementwise)."""
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver

    say("[f32 vs f64 oracle]")
    cfg = FctAleConfig(dt=0.7, dtype=jnp.float32, flux_eps=1e-7)
    solver = FctAleSolver(mesh, cfg)
    out, s = timed(solver.step, solver.init_state(fields))
    setup_s["step f32 iter=False"] = s
    for k in PHYSICAL:
        check_scaled(k, out[k], ref64[k], F32_BOUND)


def phase_vlimit(mesh, fields) -> None:
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver
    from fesom2_accelerate_tpu.ops import oracle

    say(f"[vlimit 2/3 f64 vs oracle] {mesh.n_nodes} nodes")
    mk = oracle.masks(mesh)
    for vlimit in (2, 3):
        for iter_yn in (False, True):
            cfg = FctAleConfig(dt=0.7, vlimit=vlimit, iter_yn=iter_yn,
                               dtype=jnp.float64)
            solver = FctAleSolver(mesh, cfg)
            out = solver.step(solver.init_state(fields))
            ref = oracle.fct_ale_step(mesh, fields, vlimit=vlimit,
                                      iter_yn=iter_yn, dt=0.7, mk=mk)
            for k, v in ref.items():
                check_close(f"vlimit={vlimit} iter={iter_yn} {k}", out[k], v)


def batched_fields(mesh, Tb: int, dtype=np.float32) -> tuple[list, dict]:
    """Tb tracers' fields (seeds 0..Tb-1) sharing tracer 0's hnode and
    hnode_new: (per-tracer dicts, the batched dict)."""
    from fesom2_accelerate_tpu.mesh import random_fields

    per = [random_fields(mesh, seed=t, dtype=dtype) for t in range(Tb)]
    shared = {k: per[0][k] for k in ("hnode", "hnode_new")}
    per = [{**p, **shared} for p in per]
    batched = dict(shared)
    batched.update({k: np.stack([p[k] for p in per])
                    for k in per[0] if k not in shared})
    return per, batched


def phase_tracers(mesh, setup_s: dict, Tb: int = 4, n: int = 3) -> None:
    """Tb tracers through the vmapped step vs Tb single-tracer runs.  The
    batched program may sum the KD incidences in another order, so the
    bound is f32 rounding, not bitwise."""
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver

    say(f"[tracers] Tb={Tb} f32, step and {n} scanned iterative steps")
    per, batched = batched_fields(mesh, Tb)
    for iter_yn in (False, True):
        cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=jnp.float32,
                           flux_eps=1e-7)
        solver = FctAleSolver(mesh, cfg)
        state = solver.init_state_tracers(batched)
        out, s = timed(solver.step_tracers, state)
        setup_s[f"step_tracers(Tb={Tb}) f32 iter={iter_yn}"] = s
        outs = [solver.step(solver.init_state(p)) for p in per]
        if iter_yn:
            run_b = solver.run_tracers(state, n)
            runs = [solver.run(solver.init_state(p), n) for p in per]
        for k in sorted(out):
            if k in ("hnode", "hnode_new"):
                continue
            ref = np.stack([np.asarray(o[k]) for o in outs])
            check_scaled(f"iter={iter_yn} step {k}", out[k], ref, F32_SAME)
        if iter_yn:
            for k in ("fct_LO", "fct_adf_v", "fct_adf_h"):
                ref = np.stack([np.asarray(r[k]) for r in runs])
                check_scaled(f"run({n}) {k}", run_b[k], ref, F32_SAME)


def s2r_inputs(mesh, seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    E, N = mesh.n_elems, mesh.n_nodes
    return dict(
        elem_area=np.abs(rng.standard_normal(E)) + 0.1,
        ice_strength=rng.standard_normal(E),
        sigma11=rng.standard_normal(E),
        sigma12=rng.standard_normal(E),
        sigma22=rng.standard_normal(E),
        gradient_sca=rng.standard_normal((6, E)),
        metric_factor=rng.standard_normal(E),
        inv_areamass=rng.standard_normal(N),
        rhs_a=rng.standard_normal(N),
        rhs_m=rng.standard_normal(N),
    )


def phase_stress2rhs(mesh, setup_s: dict) -> None:
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.model.stress2rhs import Stress2RhsSolver
    from fesom2_accelerate_tpu.ops import oracle

    say("[stress2rhs] f64 vs oracle, f32 vs f64")
    args = s2r_inputs(mesh)
    rU, rV = oracle.stress2rhs(mesh.elem_nodes, mesh.node_elems,
                               mesh.node_elems_pos, mesh.node_elems_num,
                               **args)
    (U, V), s = timed(lambda: Stress2RhsSolver(mesh, jnp.float64)(**args))
    setup_s["stress2rhs f64"] = s
    check_close("f64 U", U, rU)
    check_close("f64 V", V, rV)
    U32, V32 = Stress2RhsSolver(mesh, jnp.float32)(**args)
    check_scaled("f32 U", U32, U, F32_SAME)
    check_scaled("f32 V", V32, V, F32_SAME)


def phase_host_abi(mesh, fields) -> None:
    """host_embed.setup/step on numpy buffers, in this process (a second
    process would need the card too), against the in-process solver."""
    import jax.numpy as jnp

    from fesom2_accelerate_tpu import host_embed
    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver

    say(f"[host ABI] {mesh.n_nodes} nodes, backends 0 (f64) and 1 (f32)")
    elem_nodes = np.ascontiguousarray(mesh.elem_nodes, np.int32)
    nlev_elem = np.ascontiguousarray(mesh.nlev_elem, np.int32)
    node_xy = np.ascontiguousarray(mesh.node_xy, np.float64)
    names = ("ttf", "fct_LO", "fct_adf_v", "fct_adf_h", "hnode",
             "hnode_new", "del_ttf_advvert", "del_ttf_advhoriz")
    for backend, dtype in ((0, jnp.float64), (1, jnp.float32)):
        for iter_yn in (False, True):
            rc = host_embed.setup(
                mesh.n_elems, mesh.nl, elem_nodes.ctypes.data,
                nlev_elem.ctypes.data, mesh.n_nodes, node_xy.ctypes.data,
                500, 1, int(iter_yn), backend)
            assert rc == 0, f"host_embed.setup returned {rc}"
            assert host_embed.dims() == (mesh.n_nodes, mesh.n_edges,
                                         mesh.n_layers)
            # host-owned copies: the step writes its results into them
            bufs = {k: np.array(fields[k], np.float64) for k in names}
            rc = host_embed.step(*(bufs[k].ctypes.data for k in names))
            assert rc == 0, f"host_embed.step returned {rc}"
            cfg = FctAleConfig(dt=0.5, iter_yn=iter_yn, dtype=dtype,
                               **({} if backend == 0 else
                                  dict(flux_eps=1e-7)))
            solver = FctAleSolver(mesh, cfg)
            ref = solver.step(solver.init_state(fields))
            keys = ["fct_adf_v", "fct_adf_h"]
            keys += (["fct_LO"] if iter_yn
                     else ["del_ttf_advvert", "del_ttf_advhoriz"])
            for k in keys:
                tag = f"backend {backend} iter={iter_yn} {k}"
                if backend == 0:
                    check_close(tag, bufs[k], ref[k])
                else:
                    check_scaled(tag, bufs[k], ref[k], F32_SAME)
    host_embed.reset()


def phase_setup(mesh, fields, setup_s: dict) -> None:
    """Informational: first-call seconds (compile + one run) of each jitted
    step, the compiled core2 step's memory analysis, peak device memory and
    step time."""
    import jax
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver, fct_ale_step
    from fesom2_accelerate_tpu.ops.meshdata import build_mesh_data
    from fesom2_accelerate_tpu.runtime.device import gpu_name_and_power_limit

    say("[set-up and memory] (informational, not a benchmark)")
    for k, s in setup_s.items():
        say(f"  first call (compile + run) {k}: {s:.2f} s")
    cfg = FctAleConfig(dt=0.5, dtype=jnp.float32, flux_eps=1e-7)
    md = build_mesh_data(mesh, dtype=jnp.float32)
    state = {k: jnp.asarray(v, jnp.float32) for k, v in fields.items()}
    t0 = time.perf_counter()
    compiled = jax.jit(fct_ale_step, static_argnums=1).lower(
        md, cfg, state).compile()
    say(f"  compile f32 step: {time.perf_counter() - t0:.2f} s")
    say(f"  memory_analysis f32 step: {compiled.memory_analysis()}")
    card = gpu_name_and_power_limit().replace("\n", "; ")
    for name, dtype, eps in (("f32", jnp.float32, 1e-7),
                             ("f64", jnp.float64, 1e-16)):
        for iter_yn in (False, True):
            solver = FctAleSolver(mesh, FctAleConfig(
                dt=0.5, iter_yn=iter_yn, dtype=dtype, flux_eps=eps))
            ms = step_ms(solver.run, solver.init_state(fields))
            say(f"  step {name} iter={iter_yn}: {ms:.4f} ms "
                f"(20-step scan, best of 3) on {card}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def phase_multi(mesh, fields, devices, n: int = 3, Tb: int = 2) -> None:
    """The sharded solver over ``devices`` (stripes, ppermute exchange) vs
    the single-device solver, after ``n`` steps."""
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver
    from fesom2_accelerate_tpu.parallel import ShardedFctAleSolver

    P_ = len(devices)
    say(f"[multi] {P_} devices, {mesh.n_nodes} nodes, {n} steps")
    for iter_yn in (False, True):
        cfg = FctAleConfig(dt=0.3, iter_yn=iter_yn, dtype=jnp.float64)
        single = FctAleSolver(mesh, cfg)
        ref = single.run(single.init_state(fields), n)
        sh = ShardedFctAleSolver(mesh, cfg, devices=devices,
                                 exchange="ppermute")
        got = sh.gather_state(sh.run(sh.init_state(fields), n))
        for k in sorted(ref):
            check_close(f"f64 iter={iter_yn} {k}", got[k], ref[k])
        if not iter_yn:
            ref64 = ref
    cfg = FctAleConfig(dt=0.3, dtype=jnp.float32, flux_eps=1e-7)
    sh = ShardedFctAleSolver(mesh, cfg, devices=devices, exchange="ppermute")
    got = sh.gather_state(sh.run(sh.init_state(fields), n))
    for k in PHYSICAL:
        check_scaled(f"f32 vs f64 {k}", got[k], ref64[k], F32_BOUND)

    per, batched = batched_fields(mesh, Tb)
    sh = ShardedFctAleSolver(mesh, cfg, devices=devices, exchange="ppermute",
                             tracers=Tb)
    got = sh.gather_state(sh.run(sh.init_state(batched), n))
    single = FctAleSolver(mesh, cfg)
    for t in range(Tb):
        ref = single.run(single.init_state(per[t]), n)
        for k in PHYSICAL:
            check_scaled(f"f32 tracer {t} {k}", got[k][t], ref[k], F32_SAME)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded path")
    args = ap.parse_args(argv)

    import jax

    from fesom2_accelerate_tpu.runtime.device import NoGpuError

    count = 4 if args.multi else 1
    try:
        phase_device(count)
    except NoGpuError as e:
        print(e, file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)

    from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
    from fesom2_accelerate_tpu.runtime.compile_cache import (
        enable_compile_cache,
    )

    say(f"[device] compile cache: {enable_compile_cache()}")
    core2 = generate_planar_mesh(preset="core2")
    fields = random_fields(core2, seed=0)
    if args.multi:
        phase_multi(core2, fields, jax.devices()[:4])
    else:
        setup_s = {}
        ref64 = phase_f64_oracle(core2, fields, setup_s)
        phase_f32(core2, fields, ref64, setup_s)
        pi = generate_planar_mesh(preset="pi")
        pi_fields = random_fields(pi, seed=1)
        phase_vlimit(pi, pi_fields)
        phase_tracers(core2, setup_s)
        phase_stress2rhs(core2, setup_s)
        phase_host_abi(pi, pi_fields)
        phase_setup(core2, fields, setup_s)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
