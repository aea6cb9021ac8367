"""XLA compute path: jnp implementations of every FCT-ALE stage.

Functionally identical to the numpy oracle (:mod:`oracle`) — same masked
level-major math — but in jnp over a :class:`MeshData` pytree, traced once
under ``jax.jit``.  Each function carries the reference citation for its
semantics; the oracle tests pin the equivalence.

These ops are written so XLA can fuse every elementwise epilogue into the
gathers: no host round-trips, no data-dependent shapes, vertical stencils as
static shifts.  Every stage runs under a ``jax.named_scope`` carrying its
reference name (a1 .. c), so a profiler trace can be reduced by stage.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fesom2_accelerate_tpu.ops.meshdata import MeshData

_BIG = 1e30


def _scope(name: str):
    """Run the decorated stage under ``jax.named_scope(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _gather_nodes(field, idx):
    """field [L, N] gathered at idx [...] -> [L, *idx.shape] (one flat
    index vector, reshaped after)."""
    flat = jnp.take(field, idx.reshape(-1), axis=1)
    return flat.reshape(field.shape[:1] + idx.shape)


@_scope("a1")
def a1(md: MeshData, fct_LO, ttf):
    """Reference src/reference.cpp:306-319 (kernels/fct_ale_a1.cu)."""
    tmax = jnp.where(md.node_mask, jnp.maximum(fct_LO, ttf), 0.0)
    tmin = jnp.where(md.node_mask, jnp.minimum(fct_LO, ttf), 0.0)
    return tmax, tmin


@_scope("a2")
def a2(md: MeshData, tmax, tmin, bignumber):
    """Reference src/reference.cpp:321-351 (kernels/fct_ale_a2.cu), with the
    CPU reference's full-depth padding semantics."""
    g_max = _gather_nodes(tmax, md.elem_nodes)  # [L, E, 3]
    g_min = _gather_nodes(tmin, md.elem_nodes)
    UV_max = jnp.where(md.elem_mask, g_max.max(axis=2), -bignumber)
    UV_min = jnp.where(md.elem_mask, g_min.min(axis=2), bignumber)
    return UV_max, UV_min


def _cluster_reduce(md: MeshData, UV_max, UV_min):
    """Max/min over the element cluster around each node -> [L, N].

    Reference kernels/fct_ale_a3.cu:9-24 (the shared-memory CSR loop)."""
    g_max = _gather_nodes(UV_max, md.ne_idx)  # [L, N, KE]
    g_min = _gather_nodes(UV_min, md.ne_idx)
    kmask = md.ne_k[None]
    tvert_max = jnp.where(kmask, g_max, -_BIG).max(axis=2)
    tvert_min = jnp.where(kmask, g_min, _BIG).min(axis=2)
    return tvert_max, tvert_min


def _vertical_window(arr, reduce_max: bool):
    pad = jnp.full_like(arr[:1], -_BIG if reduce_max else _BIG)
    up = jnp.concatenate([pad, arr[:-1]], axis=0)
    dn = jnp.concatenate([arr[1:], pad], axis=0)
    if reduce_max:
        return jnp.maximum(jnp.maximum(up, arr), dn)
    return jnp.minimum(jnp.minimum(up, arr), dn)


@_scope("a3")
def a3_vlimit1(md: MeshData, UV_max, UV_min, fct_LO):
    """Reference src/reference.cpp:353-392 / kernels/fct_ale_a3.cu:28-44."""
    tvert_max, tvert_min = _cluster_reduce(md, UV_max, UV_min)
    wmax = _vertical_window(tvert_max, reduce_max=True)
    wmin = _vertical_window(tvert_min, reduce_max=False)
    sel_max = jnp.where(md.surface_or_bottom, tvert_max, wmax)
    sel_min = jnp.where(md.surface_or_bottom, tvert_min, wmin)
    tmax = jnp.where(md.node_mask, sel_max - fct_LO, 0.0)
    tmin = jnp.where(md.node_mask, sel_min - fct_LO, 0.0)
    return tmax, tmin


@_scope("a3")
def _a3_vlimit23(md: MeshData, UV_max, UV_min, fct_ttf_max_in, fct_LO,
                 widen: bool):
    """docs/refactoring.md:113-148 (both windows from fct_ttf_max, faithful
    to the Fortran lines 121/141)."""
    tvert_max, tvert_min = _cluster_reduce(md, UV_max, UV_min)
    wmax = _vertical_window(fct_ttf_max_in, reduce_max=True)
    wmin = _vertical_window(fct_ttf_max_in, reduce_max=False)
    if widen:
        cmax = jnp.maximum(tvert_max, wmax)
        cmin = jnp.minimum(tvert_min, wmin)
    else:
        cmax = jnp.minimum(tvert_max, wmax)
        cmin = jnp.maximum(tvert_min, wmin)
    sel_max = jnp.where(md.interior_row, cmax, tvert_max)
    sel_min = jnp.where(md.interior_row, cmin, tvert_min)
    tmax = jnp.where(md.node_mask, sel_max - fct_LO, 0.0)
    tmin = jnp.where(md.node_mask, sel_min - fct_LO, 0.0)
    return tmax, tmin


def _cluster_reduce_via_edges(md: MeshData, tmax, tmin):
    """Element-cluster reduce WITHOUT materializing a2's UV arrays.

    Algebraic identity (a fusion of reference stages a2+a3): the max
    over elements around node n of the per-element 3-node max equals the max
    over n itself and its edge-neighbors m, where neighbor m participates at
    level z iff z < nlev_edge(n, m) — because an edge's adjacent triangles
    are exactly the elements containing both endpoints, so
    ``max over adjacent elems (nlev_elem - 1) = nlev_edge`` reproduces a2's
    per-element +-bignumber level padding (src/reference.cpp:341-349)
    exactly.  Cuts the a2 [L,E,3] gather + full-depth UV write and the a3
    [L,N,K] UV gather down to ONE [L,N,KD] gather of fct_ttf_max/min."""
    g_max = _gather_nodes(tmax, md.nd_other)  # [L, N, KD]
    g_min = _gather_nodes(tmin, md.nd_other)
    m = md.nd_k[None] & _gather_nodes(md.edge_mask, md.nd_idx)
    nbr_max = jnp.where(m, g_max, -_BIG).max(axis=2)
    nbr_min = jnp.where(m, g_min, _BIG).min(axis=2)
    self_max = jnp.where(md.node_mask, tmax, -_BIG)
    self_min = jnp.where(md.node_mask, tmin, _BIG)
    return jnp.maximum(nbr_max, self_max), jnp.minimum(nbr_min, self_min)


@_scope("a3")
def a3_vlimit1_fused(md: MeshData, a1_tmax, a1_tmin, fct_LO):
    """vlimit=1 bounds from a1 output directly (a2 fused away)."""
    tvert_max, tvert_min = _cluster_reduce_via_edges(md, a1_tmax, a1_tmin)
    wmax = _vertical_window(tvert_max, reduce_max=True)
    wmin = _vertical_window(tvert_min, reduce_max=False)
    sel_max = jnp.where(md.surface_or_bottom, tvert_max, wmax)
    sel_min = jnp.where(md.surface_or_bottom, tvert_min, wmin)
    tmax = jnp.where(md.node_mask, sel_max - fct_LO, 0.0)
    tmin = jnp.where(md.node_mask, sel_min - fct_LO, 0.0)
    return tmax, tmin


def a3(md: MeshData, UV_max, UV_min, a1_tmax, fct_LO, vlimit: int):
    if vlimit == 1:
        return a3_vlimit1(md, UV_max, UV_min, fct_LO)
    return _a3_vlimit23(md, UV_max, UV_min, a1_tmax, fct_LO,
                        widen=(vlimit == 2))


@_scope("b1v")
def b1_vertical(md: MeshData, fct_adf_v):
    """Reference kernels/fct_ale_b1_vertical.cu (overwrite semantics)."""
    up = fct_adf_v[:-1]
    dn = fct_adf_v[1:]
    plus = jnp.maximum(0.0, up) + jnp.maximum(0.0, -dn)
    minus = jnp.minimum(0.0, up) + jnp.minimum(0.0, -dn)
    plus = jnp.where(md.node_mask, plus, 0.0)
    minus = jnp.where(md.node_mask, minus, 0.0)
    return plus, minus


@_scope("b1h")
def b1_horizontal(md: MeshData, fct_plus, fct_minus, fct_adf_h):
    """Deterministic scatter-as-gather replacement for the atomicAdd scatter
    in reference kernels/fct_ale_b1_horizontal.cu:24-27."""
    x = md.nd_sign[None] * _gather_nodes(fct_adf_h, md.nd_idx)
    m = md.nd_k[None] & _gather_nodes(md.edge_mask, md.nd_idx)
    plus = fct_plus + jnp.sum(jnp.where(m, jnp.maximum(0.0, x), 0.0), axis=2)
    minus = fct_minus + jnp.sum(jnp.where(m, jnp.minimum(0.0, x), 0.0), axis=2)
    return plus, minus


@_scope("b2")
def b2(md: MeshData, fct_plus, fct_minus, tmax, tmin, dt, flux_eps):
    """Reference kernels/fct_ale_b2.cu:10-11 (area_inv form)."""
    fplus = fct_plus * dt * md.area_inv + flux_eps
    fminus = fct_minus * dt * md.area_inv - flux_eps
    plus = jnp.minimum(1.0, tmax / fplus)
    minus = jnp.minimum(1.0, tmin / fminus)
    plus = jnp.where(md.node_mask, plus, 0.0)
    minus = jnp.where(md.node_mask, minus, 0.0)
    return plus, minus


@_scope("b3v")
def b3_vertical(md: MeshData, fct_plus, fct_minus, fct_adf_v,
                iter_yn: bool):
    """Reference kernels/fct_ale_b3_vertical.cu / docs/refactoring.md:204-233.

    Shifted factor rows padded with 1.0 (limiter factors are <= 1) makes the
    surface special case uniform."""
    ones = jnp.ones_like(fct_plus[:1])
    plus_m1 = jnp.concatenate([ones, fct_plus[:-1]], axis=0)
    minus_m1 = jnp.concatenate([ones, fct_minus[:-1]], axis=0)
    flux = fct_adf_v[:-1]
    ae_pos = jnp.minimum(1.0, jnp.minimum(minus_m1, fct_plus))
    ae_neg = jnp.minimum(1.0, jnp.minimum(plus_m1, fct_minus))
    ae = jnp.where(flux >= 0.0, ae_pos, ae_neg)
    active = md.vint_mask[:-1]
    out = fct_adf_v.at[:-1].set(jnp.where(active, ae * flux, flux))
    if iter_yn:
        resid = jnp.where(active & md.not_surface, (1.0 - ae) * flux, 0.0)
        adf_v2 = jnp.zeros_like(fct_adf_v).at[:-1].set(resid)
        return out, adf_v2
    return out, None


@_scope("b3h")
def b3_horizontal(md: MeshData, fct_plus, fct_minus, fct_adf_h,
                  iter_yn: bool):
    """Reference kernels/fct_ale_b3_horizontal.cu:28-39."""
    n1 = md.edges[:, 0]
    n2 = md.edges[:, 1]
    p1, m1 = jnp.take(fct_plus, n1, axis=1), jnp.take(fct_minus, n1, axis=1)
    p2, m2 = jnp.take(fct_plus, n2, axis=1), jnp.take(fct_minus, n2, axis=1)
    ae_pos = jnp.minimum(1.0, jnp.minimum(p1, m2))
    ae_neg = jnp.minimum(1.0, jnp.minimum(m1, p2))
    ae = jnp.where(fct_adf_h >= 0.0, ae_pos, ae_neg)
    out = jnp.where(md.edge_mask, ae * fct_adf_h, fct_adf_h)
    if iter_yn:
        adf_h2 = jnp.where(md.edge_mask, (1.0 - ae) * fct_adf_h, 0.0)
        return out, adf_h2
    return out, None


def edge_flux_to_nodes(md: MeshData, fct_adf_h):
    """Signed masked sum of incident-edge fluxes per node -> [L, N].

    The gather form of the reference's c_horizontal atomic scatter
    (kernels/fct_ale_c_horizontal.cu:25-26)."""
    x = md.nd_sign[None] * _gather_nodes(fct_adf_h, md.nd_idx)
    m = md.nd_k[None] & _gather_nodes(md.edge_mask, md.nd_idx)
    return jnp.sum(jnp.where(m, x, 0.0), axis=2)


@_scope("c")
def c_update_solution(md: MeshData, ttf, hnode, hnode_new, fct_LO,
                      fct_adf_v, fct_adf_h, del_ttf_advvert,
                      del_ttf_advhoriz, dt):
    """docs/refactoring.md:295-314 (kernels/fct_ale_c_{vertical,horizontal})."""
    dv = (
        -ttf * hnode
        + fct_LO * hnode_new
        + (fct_adf_v[:-1] - fct_adf_v[1:]) * dt * md.area_inv
    )
    del_v = jnp.where(md.node_mask, del_ttf_advvert + dv, del_ttf_advvert)
    dh = edge_flux_to_nodes(md, fct_adf_h) * dt * md.area_inv
    del_h = del_ttf_advhoriz + dh
    return del_v, del_h


@_scope("c")
def c_update_LO(md: MeshData, fct_LO, fct_adf_v, fct_adf_h, hnode_new, dt):
    """docs/refactoring.md:269-286 (iterative FCT)."""
    dv = (fct_adf_v[:-1] - fct_adf_v[1:]) * dt * md.area_inv / hnode_new
    out = jnp.where(md.node_mask, fct_LO + dv, fct_LO)
    dh = edge_flux_to_nodes(md, fct_adf_h) * dt * md.area_inv / hnode_new
    return out + dh


@_scope("stress2rhs")
def stress2rhs(md: MeshData, elem_area, ice_strength, sigma11, sigma12,
               sigma22, gradient_sca, metric_factor, inv_areamass,
               rhs_a, rhs_m):
    """Sea-ice EVP stress divergence, gather form.

    Reference src/reference.cpp:440-480; the element->node scatter becomes a
    masked sum over each node's incident elements with its local gradient
    coefficient."""
    idx = md.ne_idx  # [N, KE]
    pos = md.ne_pos
    E = elem_area.shape[0]

    def take1(arr, i):
        # flat-index gather, as in _gather_nodes
        return jnp.take(arr, i.reshape(-1), axis=0).reshape(i.shape)

    active = md.ne_k & (take1(ice_strength, idx) > 0.0)

    gflat = gradient_sca.reshape(-1)  # [6 * E]
    g_k = take1(gflat, pos * E + idx)
    g_k3 = take1(gflat, (pos + 3) * E + idx)
    ea = take1(elem_area, idx)
    s11 = take1(sigma11, idx)
    s12 = take1(sigma12, idx)
    s22 = take1(sigma22, idx)
    mf3 = take1(metric_factor, idx) * (1.0 / 3.0)

    u_c = -ea * (s11 * g_k + s12 * g_k3 + s12 * mf3)
    v_c = -ea * (s12 * g_k + s22 * g_k3 - s11 * mf3)
    U = jnp.sum(jnp.where(active, u_c, 0.0), axis=1)
    V = jnp.sum(jnp.where(active, v_c, 0.0), axis=1)

    has_mass = inv_areamass > 0.0
    U = jnp.where(has_mass, U * inv_areamass + rhs_a, 0.0)
    V = jnp.where(has_mass, V * inv_areamass + rhs_m, 0.0)
    return U, V
