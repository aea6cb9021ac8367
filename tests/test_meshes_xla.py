"""The XLA stage chain on irregular meshes vs the f64 numpy oracle.

The structured presets number nodes along the short grid axis; these meshes
do not: a zonally periodic cylinder renumbered by RCM, a planar mesh whose
nodes were scrambled and then RCM-reordered, and the FESOM-format
``polar_cap`` fixture (shuffled ids, read through mesh/fesom_io.py).  Every
vlimit variant and both FCT modes must match the oracle at f64 tolerance,
and ``stress2rhs`` must match on the irregular meshes too."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from fesom2_accelerate_tpu.config import FctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu.mesh.fesom_io import read_fesom_mesh
from fesom2_accelerate_tpu.mesh.generate import generate_cylinder_mesh
from fesom2_accelerate_tpu.mesh.ordering import reorder_mesh
from fesom2_accelerate_tpu.mesh.topology import build_mesh_from_elements
from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver
from fesom2_accelerate_tpu.model.stress2rhs import Stress2RhsSolver
from fesom2_accelerate_tpu.ops import oracle

from conftest import masked_allclose


def _cylinder():
    return generate_cylinder_mesh(10, 18, 7)[0]


def _rcm_scrambled():
    base = generate_planar_mesh(preset="small")
    rng = np.random.default_rng(2)
    scramble = rng.permutation(base.n_nodes).astype(np.int32)
    inv = np.empty_like(scramble)
    inv[scramble] = np.arange(base.n_nodes, dtype=np.int32)
    shuffled = build_mesh_from_elements(
        inv[base.elem_nodes], base.nlev_elem, base.nl,
        base.node_xy[scramble], area=base.area[:, scramble])
    return reorder_mesh(shuffled)[0]


def _polar_cap():
    path = os.path.join(os.path.dirname(__file__), "data", "polar_cap")
    return read_fesom_mesh(path)[0]


_MESHES = {"cylinder": _cylinder, "rcm": _rcm_scrambled,
           "polar_cap": _polar_cap}


@pytest.fixture(scope="module", params=sorted(_MESHES))
def irregular(request):
    mesh = _MESHES[request.param]()
    mesh.validate()
    return mesh, random_fields(mesh, seed=4), oracle.masks(mesh)


@pytest.mark.parametrize("vlimit", [1, 2, 3])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_chain_vs_oracle_irregular(irregular, vlimit, iter_yn):
    mesh, fields, mk = irregular
    cfg = FctAleConfig(dt=0.6, vlimit=vlimit, iter_yn=iter_yn,
                       dtype=jnp.float64)
    solver = FctAleSolver(mesh, cfg)
    out = solver.step(solver.init_state(fields))
    ref = oracle.fct_ale_step(mesh, fields, vlimit=vlimit, iter_yn=iter_yn,
                              dt=0.6, mk=mk)
    for k, v in ref.items():
        masked_allclose(np.asarray(out[k]), v, msg=f"{k} vlimit={vlimit}")


def test_stress2rhs_irregular(irregular):
    mesh = irregular[0]
    rng = np.random.default_rng(3)
    E, N = mesh.n_elems, mesh.n_nodes
    args = (np.abs(rng.standard_normal(E)) + 0.1, rng.standard_normal(E),
            *rng.standard_normal((3, E)), rng.standard_normal((6, E)),
            rng.standard_normal(E), rng.standard_normal(N),
            *rng.standard_normal((2, N)))
    U, V = Stress2RhsSolver(mesh, dtype=jnp.float64)(*args)
    rU, rV = oracle.stress2rhs(mesh.elem_nodes, mesh.node_elems,
                               mesh.node_elems_pos, mesh.node_elems_num,
                               *args)
    masked_allclose(np.asarray(U), rU, msg="U")
    masked_allclose(np.asarray(V), rV, msg="V")
