"""Bytes-moved models and roofline accounting.

The reference's perf methodology is explicit per-kernel bytes models divided
by measured time (kernels/fct_ale_a1.py:93-95 and friends; PERF.md lists
them).
This module reproduces that: an explicit per-stage byte count for the whole
FCT-ALE chain, used by bench.py to report the achieved fraction of HBM
speed-of-light.
"""

from __future__ import annotations

import numpy as np

from fesom2_accelerate_tpu.mesh.topology import Mesh

# Published device-memory bandwidth, bytes/s, keyed by the exact
# ``device_kind`` JAX reports.  Source: NVIDIA H100 and H200 data sheets
# (H100 SXM5 80 GB HBM3: 3.35 TB/s; H100 PCIe 80 GB HBM2e: 2.0 TB/s;
# H200 SXM 141 GB HBM3e: 4.8 TB/s).
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H200": 4.8e12,
}


def hbm_peak_bytes_per_s(device_kind: str) -> float:
    """Published memory bandwidth of ``device_kind``; a device that is not
    in the table is an error, never a default."""
    try:
        return HBM_PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {device_kind!r}; "
            f"known: {sorted(HBM_PEAK_BYTES_PER_S)}") from None


def fct_ale_step_bytes(mesh: Mesh, itemsize: int = 4,
                       iter_yn: bool = False) -> int:
    """Modeled HBM traffic of one full a->b->c step, reference-style.

    Counts every array read/write once per stage at ``itemsize`` bytes per
    active entry (gathers counted once per incidence, like the reference's
    per-edge/per-cluster accounting in kernels/fct_ale_a3.py:116-151 and
    kernels/fct_ale_b1_horizontal.py:70-89).  Index/mask traffic (int32/bool)
    is included at 4/1 bytes.  This is the denominator model for the
    fraction-of-speed-of-light metric; fused execution can beat it only by
    keeping intermediates on chip, which is exactly what we want to reward.
    """
    L = mesh.n_layers
    nod = int(np.sum(mesh.nlev_nod - 1))  # active node-layers
    elem_active = int(np.sum(mesh.nlev_elem - 1))
    elem_full = L * mesh.n_elems  # a2 writes padded full depth
    edge = int(np.sum(mesh.nlev_edge))
    deg_e = int(np.sum(mesh.node_elems_num * (mesh.nlev_nod - 1)))
    deg_d = int(np.sum(mesh.node_edges_num * (mesh.nlev_nod - 1)))
    vint = int(np.sum(mesh.nlev_nod))  # interfaces incl. bottom
    f = itemsize

    b = 0
    # a1: read fct_LO, ttf; write tmax, tmin
    b += 4 * nod * f
    # a2: gather tmax,tmin at 3 nodes; write UV pair over full depth
    b += (2 * 3 * elem_active + 2 * elem_full) * f + 3 * 4 * mesh.n_elems
    # a3: gather UV pair over node's element cluster; read fct_LO;
    #     write tmax2, tmin2
    b += (2 * deg_e + 3 * nod) * f + 4 * deg_e // max(L - 1, 1)
    # b1v: read adf_v interfaces; write fct_plus/minus
    b += (vint + 2 * nod) * f
    # b1h: gather adf_h per node-edge incidence; read+write fct_plus/minus
    b += (deg_d + 4 * nod) * f + 4 * deg_d // max(L - 1, 1)
    # b2: read fct_plus/minus, tmax2, tmin2, area_inv; write fct_plus/minus
    b += 7 * nod * f
    # b3v: read fct_plus/minus, adf_v; write adf_v
    b += (2 * nod + 2 * vint) * f
    # b3h: gather fct_plus/minus at both edge ends; read+write adf_h
    b += (4 * edge + 2 * edge) * f + 2 * 4 * mesh.n_edges
    if iter_yn:
        # residual fluxes written in b3 + fct_LO update (read LO, hnode_new,
        # adf_v, gather adf_h; write LO)
        b += (vint + edge) * f
        b += (3 * nod + vint + deg_d + nod) * f
    else:
        # c: read ttf, hnode, LO, hnode_new, adf_v, del_v, del_h,
        #    gather adf_h; write del_v, del_h
        b += (7 * nod + vint + deg_d + 2 * nod) * f
    return b


def grid_points(mesh: Mesh) -> int:
    """Active node-layers per step — the grid points a step advances."""
    return int(np.sum(mesh.nlev_nod - 1))


def stress2rhs_bytes(mesh: Mesh, itemsize: int = 4) -> int:
    """Modeled HBM traffic of one stress2rhs call (the second workload;
    reference src/reference.cpp:440-480), reference-style accounting:

    per element — 3 stress components, area+ice activity, metric factor,
    6 shape-function gradients read once (:445-462); the element->node
    scatter of the 2 (u, v) contributions at 3 corners counted once per
    incidence like the reference's per-edge models
    (kernels/fct_ale_b1_horizontal.py:70-89); per node — inv_areamass,
    rhs_a, rhs_m reads and the U/V writes (:464-476); int32 connectivity."""
    E, N = mesh.n_elems, mesh.n_nodes
    f = itemsize
    b = (3 + 1 + 1 + 6) * E * f  # element inputs
    b += 2 * 3 * E * f  # u/v contribution per corner incidence
    b += 5 * N * f  # inv_areamass, rhs_a, rhs_m reads; U, V writes
    b += 3 * 4 * E  # elem_nodes int32
    return b


def measure_stream_bandwidth(n_bytes: int = 2 ** 29, iters: int = 20,
                             reps: int = 3) -> float:
    """Measured streaming bandwidth of the default device (bytes/s): a
    scan-chained triad (2 reads + 1 write of a large f32 array per step),
    timed around ``block_until_ready``, best of ``reps``.  A copy rate
    measured in the same process as a kernel is the roof that kernel's
    achieved bandwidth is best compared with."""
    import time

    import jax
    import jax.numpy as jnp

    n = n_bytes // 4
    x = jnp.ones((n,), jnp.float32)
    b = jnp.ones((n,), jnp.float32)

    @jax.jit
    def run(a, b):
        def body(c, _):
            return c + b * 0.5, None

        y, _ = jax.lax.scan(body, a, None, length=iters)
        return y

    jax.block_until_ready(run(x, b))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(x, b))
        best = min(best, time.perf_counter() - t0)
    return 3.0 * n_bytes * iters / best
