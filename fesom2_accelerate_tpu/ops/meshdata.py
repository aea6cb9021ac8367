"""Device-resident mesh data for the accelerated paths.

The reference uploads connectivity once via ``transfer_mesh_`` and keeps it
GPU-resident (reference src/fesom2-accelerate.cu:114-127); ``MeshData`` is
the equivalent here: a pytree of jnp arrays (connectivity, activity masks,
inverse areas) built once per mesh and passed to the jitted step as an
argument.

The level axis is kept at its natural size and leads ([L, X], level-major),
so a row of one level is contiguous over the mesh entities.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from fesom2_accelerate_tpu.mesh.topology import Mesh
from fesom2_accelerate_tpu.ops import oracle


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeshData:
    """jnp mirror of Mesh connectivity + precomputed masks (all data fields)."""

    # connectivity (int32)
    elem_nodes: jax.Array  # [E, 3]
    edges: jax.Array  # [Ed, 2]
    ne_idx: jax.Array  # [N, KE] node->elem incidence (padded with 0)
    ne_pos: jax.Array  # [N, KE] local node position in the element
    nd_idx: jax.Array  # [N, KD] node->edge incidence (padded with 0)
    nd_other: jax.Array  # [N, KD] the OTHER endpoint of each incident edge

    # masks / weights
    node_mask: jax.Array  # [L, N] bool, z < nlev_nod - 1
    elem_mask: jax.Array  # [L, E] bool
    edge_mask: jax.Array  # [L, Ed] bool
    vint_mask: jax.Array  # [L+1, N] bool, active vertical interfaces
    ne_k: jax.Array  # [N, KE] bool, valid incidence slots
    nd_k: jax.Array  # [N, KD] bool
    nd_sign: jax.Array  # [N, KD] dtype, +-1 (0 in padding)

    # geometry
    area_inv: jax.Array  # [L, N] (layer rows of 1/area)

    # vertical structure helpers
    surface_or_bottom: jax.Array  # [L, N] bool: z==0 or z>=nlev-2 (a3 vlimit1)
    interior_row: jax.Array  # [L, N] bool: 1 <= z <= nlev-3 (a3 vlimit2/3)
    not_surface: jax.Array  # [L, N] bool: z >= 1 (b3v residual rows)


def build_mesh_data(mesh: Mesh, dtype=jnp.float32, xp=jnp) -> MeshData:
    """Build the device pytree; cast float data to the compute dtype.

    ``xp=np`` keeps everything host-side (no default-device placement) —
    used by the sharded solver, which stacks per-part data and places it
    with an explicit sharding in one transfer."""
    mk = oracle.masks(mesh)
    L = mesh.n_layers
    z = np.arange(L)[:, None]
    bottom = mesh.nlev_nod[None, :] - 2
    surface_or_bottom = (z == 0) | (z >= bottom)
    interior_row = (z >= 1) & (z <= mesh.nlev_nod[None, :] - 3)
    not_surface = np.broadcast_to(z >= 1, (L, mesh.n_nodes))

    f = lambda x: xp.asarray(x, dtype=dtype)
    i = lambda x: xp.asarray(x, dtype=jnp.int32)
    b = lambda x: xp.asarray(x, dtype=jnp.bool_)

    # other endpoint of each incident edge (used by the fused a2+a3
    # neighbor-max formulation): sign +1 means this node is the edge start,
    # so the neighbor is the end node
    ends = mesh.edges[mk["nd_idx"]]  # [N, KD, 2]
    nd_other = np.where(mesh.node_edges_sign == 1, ends[:, :, 1],
                        ends[:, :, 0])
    nd_other = np.where(mesh.node_edges >= 0, nd_other, 0)

    return MeshData(
        elem_nodes=i(mesh.elem_nodes),
        edges=i(mesh.edges),
        ne_idx=i(mk["ne_idx"]),
        ne_pos=i(np.where(mesh.node_elems_pos >= 0, mesh.node_elems_pos, 0)),
        nd_idx=i(mk["nd_idx"]),
        nd_other=i(nd_other),
        node_mask=b(mk["node_mask"]),
        elem_mask=b(mk["elem_mask"]),
        edge_mask=b(mk["edge_mask"]),
        vint_mask=b(mk["vint_mask"]),
        ne_k=b(mk["ne_k"]),
        nd_k=b(mk["nd_k"]),
        nd_sign=f(mk["nd_sign"]),
        area_inv=f(mesh.area_inv[:L]),
        surface_or_bottom=b(surface_or_bottom),
        interior_row=b(interior_row),
        not_surface=b(not_surface),
    )


def fields_to_device(fields: dict, dtype=jnp.float32) -> dict:
    return {k: jnp.asarray(v, dtype=dtype) for k, v in fields.items()}
