"""Bandwidth-reducing mesh reordering (reverse Cuthill-McKee).

The stage gathers read each node's neighbours, so they touch memory the
way the node numbering lays it out: with a bandwidth-reducing numbering the
neighbours of consecutive nodes lie close together in every level row, and
stripe partitions (parallel/partition.py) keep small halos.  Generated
meshes are row-major and already local; real FESOM meshes arrive in
arbitrary order, so this module provides:

* :func:`rcm_order` — reverse Cuthill-McKee over the node adjacency;
* :func:`reorder_mesh` — apply node/element/edge permutations and rebuild
  the mesh (elements sorted by their minimum node, edges re-derived, which
  orders them by min endpoint).

This stands in for the reference's reliance on the host model's
domain-local numbering (docs/refactoring.md:31).
"""

from __future__ import annotations

import numpy as np

from fesom2_accelerate_tpu.mesh.topology import Mesh, build_mesh_from_elements


def _adjacency(elem_nodes: np.ndarray, n_nodes: int):
    """CSR node-node adjacency from shared elements."""
    pairs = []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        pairs.append(elem_nodes[:, (a, b)])
        pairs.append(elem_nodes[:, (b, a)])
    pairs = np.concatenate(pairs, axis=0)
    keys = pairs[:, 0].astype(np.int64) * n_nodes + pairs[:, 1]
    keys = np.unique(keys)
    src = (keys // n_nodes).astype(np.int32)
    dst = (keys % n_nodes).astype(np.int32)
    counts = np.bincount(src, minlength=n_nodes)
    offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, dst


def rcm_order(mesh: Mesh) -> np.ndarray:
    """Permutation ``perm`` with perm[new_id] = old_id (reverse CM)."""
    N = mesh.n_nodes
    offsets, dst = _adjacency(mesh.elem_nodes, N)
    degree = np.diff(offsets)
    visited = np.zeros(N, dtype=bool)
    order = np.empty(N, dtype=np.int32)
    pos = 0
    for start_candidate in np.argsort(degree, kind="stable"):
        if visited[start_candidate]:
            continue
        # BFS from a minimum-degree node of this component
        queue = [int(start_candidate)]
        visited[start_candidate] = True
        while queue:
            nxt = []
            for n in queue:
                order[pos] = n
                pos += 1
                nbrs = dst[offsets[n]:offsets[n + 1]]
                nbrs = nbrs[~visited[nbrs]]
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                nxt.extend(int(x) for x in nbrs)
            queue = nxt
    assert pos == N
    return order[::-1].copy()  # reverse CM


def reorder_mesh(mesh: Mesh, perm: np.ndarray | None = None):
    """Rebuild the mesh under a node permutation (default: RCM).

    Returns (new_mesh, node_perm) where ``node_perm[new] = old``; node
    fields move with ``field[..., node_perm]``.  Elements are renumbered by
    ascending minimum (new) node id; edges are re-derived and therefore
    sorted by min endpoint.  Element/edge fields must be rebuilt from the
    new mesh (use new_mesh arrays), so reorder BEFORE generating fields."""
    if perm is None:
        perm = rcm_order(mesh)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)

    elem_nodes_new = inv[mesh.elem_nodes]
    elem_order = np.argsort(elem_nodes_new.min(axis=1), kind="stable")
    elem_nodes_new = elem_nodes_new[elem_order]
    nlev_elem_new = mesh.nlev_elem[elem_order]
    node_xy_new = mesh.node_xy[perm]
    area_new = mesh.area[:, perm]

    new_mesh = build_mesh_from_elements(
        elem_nodes_new, nlev_elem_new, mesh.nl, node_xy_new, area=area_new
    )
    return new_mesh, perm


def rcb_order(mesh: Mesh, n_parts: int):
    """Recursive coordinate bisection: a surface-minimizing 2-D partition
    (the reference inherits general graph partitions from host FESOM,
    docs/refactoring.md:31; RCB is the coordinate-space classic).

    Returns ``(perm, counts)``: a node permutation (``perm[new] = old``)
    that makes every RCB part a CONTIGUOUS range of the new numbering —
    so the stripe partitioner's [H | owned | H] machinery and multi-hop
    packed exchange apply unchanged to the 2-D partition — plus the
    per-part owned-node counts.  Within each part nodes keep their original
    relative (bandwidth-ordered) numbering; parts are emitted in recursion
    order, which keeps spatially adjacent parts close in part index (small
    exchange hop radius).

    Apply with :func:`reorder_mesh` and pass ``counts`` to
    ``parallel.partition_mesh``."""
    xy = mesh.node_xy
    out_chunks = []

    def rec(ids, k):
        if k == 1:
            out_chunks.append(ids)
            return
        k1 = k // 2
        # split along the longer extent, proportionally to the child counts
        ext = xy[ids].max(axis=0) - xy[ids].min(axis=0)
        axis = int(np.argmax(ext))
        order = np.argsort(xy[ids, axis], kind="stable")
        cut = (len(ids) * k1) // k
        rec(np.sort(ids[order[:cut]]), k1)
        rec(np.sort(ids[order[cut:]]), k - k1)

    rec(np.arange(mesh.n_nodes, dtype=np.int64), n_parts)
    perm = np.concatenate(out_chunks).astype(np.int64)
    counts = np.array([len(c) for c in out_chunks], dtype=np.int64)
    return perm, counts


def halo_fraction(mesh: Mesh, owner: np.ndarray, n_parts: int) -> float:
    """Sum of per-part halo sizes / N — the partition-quality metric the
    exchange volume is proportional to."""
    total = 0
    for p in range(n_parts):
        sel = (owner[mesh.elem_nodes] == p).any(axis=1)
        nodes = np.unique(mesh.elem_nodes[sel])
        total += int((owner[nodes] != p).sum())
    return total / mesh.n_nodes


def bandwidth(mesh: Mesh) -> int:
    """Max |i - j| over element node pairs — the locality metric of a
    numbering (and the halo width of a stripe partition)."""
    en = mesh.elem_nodes
    return int((en.max(axis=1) - en.min(axis=1)).max())
