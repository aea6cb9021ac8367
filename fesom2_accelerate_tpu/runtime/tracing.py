"""Per-stage timing and profiler helpers.

The reference's observability is compile-time stderr timing
(``TIME_TRANSFERS``, include/fesom2-accelerate.h:13,70-88) and the
kernel_tuner per-config time + modeled bandwidth report
(kernels/fct_ale_a1.py:93-95).  Equivalents here:

* :func:`time_stages` — wall-time each jitted stage of the chain and report
  effective bandwidth against the bytes models in profiling.py;
* :func:`trace` — context manager around ``jax.profiler`` for traces.
"""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (view with XProf / TensorBoard /
    Perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _timeit(fn, *args, iters: int = 20) -> float:
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def time_stages(mesh, fields, dtype=None, iters: int = 20) -> dict:
    """Per-stage wall time + effective GB/s for the XLA path.

    Returns {stage: {"ms": .., "GBps": ..}} using per-stage bytes models
    consistent with profiling.fct_ale_step_bytes."""
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.ops import stages
    from fesom2_accelerate_tpu.ops.meshdata import build_mesh_data

    dtype = dtype or jnp.float32
    fsize = jnp.dtype(dtype).itemsize
    md = build_mesh_data(mesh, dtype=dtype)
    s = {k: jnp.asarray(v, dtype) for k, v in fields.items()}
    L = mesh.n_layers
    nod = int(np.sum(mesh.nlev_nod - 1))
    elem = int(np.sum(mesh.nlev_elem - 1))
    edge = int(np.sum(mesh.nlev_edge))
    deg_e = int(np.sum(mesh.node_elems_num * (mesh.nlev_nod - 1)))
    deg_d = int(np.sum(mesh.node_edges_num * (mesh.nlev_nod - 1)))
    vint = int(np.sum(mesh.nlev_nod))

    report = {}

    # md is always the FIRST jit argument (closure-captured device arrays
    # would be inlined as HLO constants — extreme compile times)
    def bench(name, fn, nbytes, *args):
        jf = jax.jit(fn)
        ms = _timeit(jf, md, *args, iters=iters) * 1e3
        report[name] = {"ms": round(ms, 4),
                        "GBps": round(nbytes / (ms * 1e-3) / 1e9, 2)}
        return jf(md, *args)

    tmax, tmin = bench(
        "a1", lambda m_, a, b: stages.a1(m_, a, b), 4 * nod * fsize,
        s["fct_LO"], s["ttf"],
    )
    UVx, UVn = bench(
        "a2", lambda m_, a, b: stages.a2(m_, a, b, 1e3),
        (6 * elem + 2 * L * mesh.n_elems) * fsize, tmax, tmin,
    )
    t2x, t2n = bench(
        "a3", lambda m_, a, b, c: stages.a3_vlimit1(m_, a, b, c),
        (2 * deg_e + 3 * nod) * fsize, UVx, UVn, s["fct_LO"],
    )
    p, m = bench(
        "b1v", lambda m_, v: stages.b1_vertical(m_, v),
        (vint + 2 * nod) * fsize, s["fct_adf_v"],
    )
    p, m = bench(
        "b1h", lambda m_, p, q, h: stages.b1_horizontal(m_, p, q, h),
        (deg_d + 4 * nod) * fsize, p, m, s["fct_adf_h"],
    )
    p, m = bench(
        "b2", lambda m_, p, q, a, b: stages.b2(m_, p, q, a, b, 1.0, 1e-7),
        7 * nod * fsize, p, m, t2x, t2n,
    )
    adf_v = bench(
        "b3v", lambda m_, p, q, v: stages.b3_vertical(m_, p, q, v, False)[0],
        (2 * nod + 2 * vint) * fsize, p, m, s["fct_adf_v"],
    )
    adf_h = bench(
        "b3h", lambda m_, p, q, h: stages.b3_horizontal(m_, p, q, h,
                                                        False)[0],
        6 * edge * fsize, p, m, s["fct_adf_h"],
    )
    bench(
        "c", lambda m_, av, ah: stages.c_update_solution(
            m_, s["ttf"], s["hnode"], s["hnode_new"], s["fct_LO"], av, ah,
            s["del_ttf_advvert"], s["del_ttf_advhoriz"], 1.0),
        (9 * nod + vint + deg_d) * fsize, adf_v, adf_h,
    )
    return report
