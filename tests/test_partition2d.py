"""2-D (recursive coordinate bisection) domain decomposition.

The reference inherits general graph partitions from host FESOM
(docs/refactoring.md:31); stripes are optimal only while P is small.  RCB
(mesh/ordering.rcb_order) renumbers the mesh so every 2-D part is a
CONTIGUOUS node range, which reuses the whole [H | owned | H] + multi-hop
packed-exchange machinery unchanged.  These tests pin:

* partition quality: the RCB partition's total halo fraction beats the
  stripe partition's on a wide mesh at P large enough for 2-D to win;
* end-to-end exactness: the sharded step over the RCB partition matches
  the single-device solver.
"""

import numpy as np
import jax.numpy as jnp

from fesom2_accelerate_tpu.config import FctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu.mesh.ordering import (
    halo_fraction,
    rcb_order,
    reorder_mesh,
)
from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver
from fesom2_accelerate_tpu.parallel import ShardedFctAleSolver

from conftest import masked_allclose


def _owners(counts, N):
    owner = np.empty(N, dtype=np.int32)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    for p in range(len(counts)):
        owner[bounds[p]:bounds[p + 1]] = p
    return owner


def test_rcb_partition_quality():
    """8-way RCB on a square-ish mesh cuts halo volume vs 8 stripes."""
    mesh = generate_planar_mesh(nx=48, ny=48, nl=6)
    P = 8
    m2, perm = reorder_mesh(mesh, rcb_order(mesh, P)[0])
    counts = rcb_order(mesh, P)[1]
    # stripes on the original bandwidth-ordered mesh
    stripe_owner = _owners([mesh.n_nodes // P] * (P - 1)
                           + [mesh.n_nodes - (P - 1) * (mesh.n_nodes // P)],
                           mesh.n_nodes)
    hf_stripe = halo_fraction(mesh, stripe_owner, P)
    hf_rcb = halo_fraction(m2, _owners(counts, m2.n_nodes), P)
    assert hf_rcb < hf_stripe, (hf_rcb, hf_stripe)


def test_rcb_sharded_matches_single():
    """Sharded step over the 2-D RCB partition is exact vs single-device:
    contiguous-range machinery + multi-hop exchange handle the 2-D
    neighbor graph (owner offsets span many part indices)."""
    mesh = generate_planar_mesh(nx=24, ny=24, nl=6)
    P = 8
    perm, counts = rcb_order(mesh, P)
    m2, _ = reorder_mesh(mesh, perm)
    fields = random_fields(m2, seed=5)
    cfg = FctAleConfig(dt=0.7, dtype=jnp.float64)

    ref_solver = FctAleSolver(m2, cfg)
    ref_out = ref_solver.step(ref_solver.init_state(fields))

    sh = ShardedFctAleSolver(m2, cfg, part_counts=counts)
    assert sh.n_parts == P
    out = sh.step(sh.init_state(fields))
    for k in ("fct_plus", "fct_minus", "fct_ttf_max", "del_ttf_advvert",
              "del_ttf_advhoriz"):
        masked_allclose(sh.gather_node(out[k]), np.asarray(ref_out[k]),
                        rtol=1e-12, atol=1e-12, msg=f"rcb[{k}]")
