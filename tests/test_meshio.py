"""Real-mesh ingestion: FESOM2 mesh files + periodic (cylindrical) meshes.

The reference takes connectivity from host FESOM2 (reference
src/fesom2-accelerate.cu:114-127) whose meshes are global and zonally
periodic (docs/refactoring.md:13-19); these tests cover the standalone
replacements: the ASCII mesh reader (mesh/fesom_io.py) and a periodic
synthetic generator whose RCM renumbering absorbs the seam."""

import numpy as np

from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu.mesh.fesom_io import (
    read_fesom_mesh,
    write_fesom_mesh,
)
from fesom2_accelerate_tpu.mesh.generate import generate_cylinder_mesh
from fesom2_accelerate_tpu.mesh.ordering import bandwidth
from fesom2_accelerate_tpu.ops import oracle


def test_fesom_roundtrip(tmp_path):
    mesh = generate_planar_mesh(preset="tiny")
    write_fesom_mesh(str(tmp_path), mesh)
    back, perm = read_fesom_mesh(str(tmp_path), reorder=False)
    assert perm is None
    back.validate()
    assert back.n_nodes == mesh.n_nodes and back.nl == mesh.nl
    np.testing.assert_array_equal(back.elem_nodes, mesh.elem_nodes)
    np.testing.assert_array_equal(back.nlev_nod, mesh.nlev_nod)
    np.testing.assert_allclose(back.node_xy, mesh.node_xy, atol=1e-7)
    # element levels are re-derived as min over corners (FESOM2 rule):
    # never deeper than any corner, and consistent with node levels
    assert (back.nlev_elem <= back.nlev_nod[back.elem_nodes].min(axis=1)
            ).all()


def test_fesom_read_reordered_runs_chain(tmp_path):
    """Read-back mesh (RCM-reordered like any real FESOM mesh would be)
    runs the full oracle chain and validates."""
    mesh = generate_planar_mesh(preset="tiny")
    write_fesom_mesh(str(tmp_path), mesh)
    back, perm = read_fesom_mesh(str(tmp_path))
    assert perm is not None
    back.validate()
    fields = random_fields(back, seed=1)
    out = oracle.fct_ale_step(back, fields, vlimit=1, dt=0.5)
    assert np.isfinite(out["del_ttf_advvert"]).all()


def test_cylinder_mesh_seam_bandwidth():
    """RCM absorbs the periodic seam: bandwidth stays ~2x circumference,
    NOT ~N (the raw seam ordering)."""
    raw, _ = generate_cylinder_mesh(12, 24, 6, reorder=False)
    rcm, _ = generate_cylinder_mesh(12, 24, 6)
    raw.validate()
    rcm.validate()
    assert bandwidth(raw) >= raw.n_nodes - 2 * 24  # the seam: ids ~N apart
    assert bandwidth(rcm) <= 3 * 12  # ~2x circumference + slack


def test_real_format_fixture_end_to_end():
    """A FESOM-format mesh sample NOT produced by write_fesom_mesh
    (tests/data/polar_cap, scripts/make_fixture_mesh.py: comment headers,
    shuffled ids, boundary flags, positive-down depths, CRLF) parses, and
    the f32 solver + the sharded path run on it and agree with the f64
    oracle / single-device solver."""
    import os

    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver
    from fesom2_accelerate_tpu.parallel import ShardedFctAleSolver

    path = os.path.join(os.path.dirname(__file__), "data", "polar_cap")
    mesh, perm = read_fesom_mesh(path)
    mesh.validate()
    assert perm is not None and mesh.n_nodes == 631

    fields = random_fields(mesh, seed=9, dtype=np.float32)
    cfg = FctAleConfig(dt=0.5, dtype=jnp.float32, flux_eps=1e-7)
    ref = oracle.fct_ale_step(
        mesh, {k: v.astype(np.float64) for k, v in fields.items()},
        vlimit=1, dt=0.5, flux_eps=1e-7)

    # f32 solver vs the f64 oracle
    solver = FctAleSolver(mesh, cfg)
    out = solver.step(solver.init_state(fields))
    for k in ("fct_plus", "fct_minus", "fct_adf_h", "del_ttf_advvert",
              "del_ttf_advhoriz"):
        a = np.asarray(out[k], np.float64)
        err = np.abs(a - ref[k]).max() / max(np.abs(ref[k]).max(), 1.0)
        assert err < 2e-5, f"f32[{k}] relerr {err:.2e}"

    # sharded path (f64, exact) on the same ingested mesh
    cfg64 = FctAleConfig(dt=0.5, dtype=jnp.float64)
    fields64 = {k: v.astype(np.float64) for k, v in fields.items()}
    single = FctAleSolver(mesh, cfg64)
    ref_out = single.step(single.init_state(fields64))
    sh = ShardedFctAleSolver(mesh, cfg64)
    out_sh = sh.step(sh.init_state(fields64))
    for k in ("fct_plus", "del_ttf_advhoriz"):
        got = sh.gather_node(out_sh[k])
        np.testing.assert_allclose(got, np.asarray(ref_out[k]),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
