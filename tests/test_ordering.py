"""RCM reordering: locality restoration for arbitrary input orderings."""

import numpy as np

from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu.mesh.ordering import bandwidth, rcm_order, reorder_mesh
from fesom2_accelerate_tpu.mesh.topology import build_mesh_from_elements
from fesom2_accelerate_tpu.ops import oracle

from conftest import masked_allclose


def _shuffled_mesh(seed=0, preset="small"):
    """A small mesh with nodes renumbered randomly (worst-case locality)."""
    base = generate_planar_mesh(preset=preset)
    rng = np.random.default_rng(seed)
    scramble = rng.permutation(base.n_nodes).astype(np.int32)
    inv = np.empty_like(scramble)
    inv[scramble] = np.arange(base.n_nodes, dtype=np.int32)
    elem_nodes = inv[base.elem_nodes]
    return base, build_mesh_from_elements(
        elem_nodes, base.nlev_elem, base.nl, base.node_xy[scramble],
        area=base.area[:, scramble],
    )


def test_rcm_is_permutation(small_mesh):
    perm = rcm_order(small_mesh)
    assert sorted(perm.tolist()) == list(range(small_mesh.n_nodes))


def test_rcm_restores_locality():
    base, shuffled = _shuffled_mesh()
    bw_shuffled = bandwidth(shuffled)
    reordered, _ = reorder_mesh(shuffled)
    bw_rcm = bandwidth(reordered)
    assert bw_shuffled > 5 * bw_rcm  # scrambled ~N, RCM ~grid width
    # RCM bandwidth is comparable to the native row-major layout
    assert bw_rcm <= 3 * bandwidth(base)


def test_reorder_preserves_physics():
    """The FCT step commutes with reordering: run on the reordered mesh and
    map back, vs run on the original."""
    base, shuffled = _shuffled_mesh(seed=1)
    reordered, perm = reorder_mesh(shuffled)

    fields_shuffled = random_fields(shuffled, seed=4)
    # node fields move by gather; edge fields must be re-derived on the new
    # edge set: build a global edge key -> value map
    out_ref = oracle.fct_ale_step(shuffled, fields_shuffled, dt=0.7)

    fields_new = dict(fields_shuffled)
    for k in ("ttf", "fct_LO", "fct_adf_v", "hnode", "hnode_new",
              "del_ttf_advvert", "del_ttf_advhoriz"):
        fields_new[k] = fields_shuffled[k][..., perm]
    # edge mapping: (min,max) endpoint pair in OLD ids identifies an edge;
    # sign flips if orientation flipped
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    old_edges = shuffled.edges
    key_old = {}
    for ed, (a, b) in enumerate(old_edges):
        key_old[(min(a, b), max(a, b))] = (ed, a < b)
    adf_h_new = np.zeros((shuffled.n_layers, reordered.n_edges))
    for ed, (a_new, b_new) in enumerate(reordered.edges):
        a_old, b_old = perm[a_new], perm[b_new]
        old_ed, old_fwd = key_old[(min(a_old, b_old), max(a_old, b_old))]
        sign = 1.0 if (a_old < b_old) == old_fwd else -1.0
        adf_h_new[:, ed] = sign * fields_shuffled["fct_adf_h"][:, old_ed]
    fields_new["fct_adf_h"] = adf_h_new

    out_new = oracle.fct_ale_step(reordered, fields_new, dt=0.7)
    for k in ("fct_plus", "fct_minus", "del_ttf_advvert",
              "del_ttf_advhoriz"):
        masked_allclose(out_new[k], out_ref[k][..., perm], rtol=1e-11,
                        atol=1e-12, msg=f"reordered[{k}]")
