"""XLA (jnp) compute path vs vectorized numpy oracle — per stage, full chain,
multi-step iterative integration.  f64, exact-ish tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest

from fesom2_accelerate_tpu.config import FctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver, fct_ale_step
from fesom2_accelerate_tpu.model.stress2rhs import Stress2RhsSolver
from fesom2_accelerate_tpu.ops import oracle
from fesom2_accelerate_tpu.ops.meshdata import build_mesh_data

from conftest import masked_allclose


@pytest.fixture(scope="module")
def setup():
    mesh = generate_planar_mesh(preset="small")
    mesh.validate()
    fields = random_fields(mesh, seed=7)
    mk = oracle.masks(mesh)
    md = build_mesh_data(mesh, dtype=jnp.float64)
    return mesh, fields, mk, md


@pytest.mark.parametrize("vlimit", [1, 2, 3])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_full_chain_vs_oracle(setup, vlimit, iter_yn):
    mesh, fields, mk, md = setup
    cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.7,
                       dtype=jnp.float64)
    state = {k: jnp.asarray(v) for k, v in fields.items()}
    out = fct_ale_step(md, cfg, state)
    ref = oracle.fct_ale_step(mesh, fields, vlimit=vlimit, iter_yn=iter_yn,
                              dt=0.7, mk=mk)
    for key, val in ref.items():
        masked_allclose(np.asarray(out[key]), val, rtol=1e-12, atol=1e-12,
                        msg=f"xla[{key}] vlimit={vlimit} iter={iter_yn}")


def test_multistep_iterative_integration(setup):
    """N iterative-FCT steps on device (lax.scan) vs N oracle steps: the
    'allclose after N timesteps' gate of BASELINE.json."""
    mesh, fields, mk, _ = setup
    n_steps = 5
    cfg = FctAleConfig(vlimit=1, iter_yn=True, dt=0.3, dtype=jnp.float64)
    solver = FctAleSolver(mesh, cfg)
    state = solver.init_state(fields)
    state = solver.run(state, n_steps)

    ref_fields = {k: v.copy() for k, v in fields.items()}
    for _ in range(n_steps):
        out = oracle.fct_ale_step(mesh, ref_fields, vlimit=1, iter_yn=True,
                                  dt=0.3, mk=mk)
        ref_fields["fct_LO"] = out["fct_LO"]
        ref_fields["fct_adf_v"] = out["fct_adf_v"]
        ref_fields["fct_adf_h"] = out["fct_adf_h"]

    masked_allclose(np.asarray(state["fct_LO"]), ref_fields["fct_LO"],
                    rtol=1e-10, atol=1e-11, msg="fct_LO after N steps")
    masked_allclose(np.asarray(state["fct_adf_v"]), ref_fields["fct_adf_v"],
                    rtol=1e-10, atol=1e-11, msg="fct_adf_v after N steps")
    masked_allclose(np.asarray(state["fct_adf_h"]), ref_fields["fct_adf_h"],
                    rtol=1e-10, atol=1e-11, msg="fct_adf_h after N steps")


def test_f32_path_tracks_f64(setup):
    """The f32 step must track the f64 gate within documented bounds
    (SURVEY §7 hard part 2)."""
    mesh, fields, mk, _ = setup
    cfg64 = FctAleConfig(dt=0.7, dtype=jnp.float64)
    cfg32 = FctAleConfig(dt=0.7, flux_eps=1e-7, dtype=jnp.float32)
    md64 = build_mesh_data(mesh, dtype=jnp.float64)
    md32 = build_mesh_data(mesh, dtype=jnp.float32)
    s64 = {k: jnp.asarray(v, jnp.float64) for k, v in fields.items()}
    s32 = {k: jnp.asarray(v, jnp.float32) for k, v in fields.items()}
    o64 = fct_ale_step(md64, cfg64, s64)
    o32 = fct_ale_step(md32, cfg32, s32)
    # solution increments stay close; limiter factors can differ at
    # switching points, so compare the physically meaningful outputs
    for key in ("fct_adf_v", "fct_adf_h", "del_ttf_advvert",
                "del_ttf_advhoriz"):
        a = np.asarray(o64[key])
        b = np.asarray(o32[key], dtype=np.float64)
        scale = np.maximum(np.abs(a).max(), 1.0)
        assert np.abs(a - b).max() / scale < 5e-5, key


def test_stress2rhs_vs_oracle(setup):
    mesh, _, _, _ = setup
    rng = np.random.default_rng(11)
    E, N = mesh.n_elems, mesh.n_nodes
    args = dict(
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
    solver = Stress2RhsSolver(mesh, dtype=jnp.float64)
    U, V = solver(**args)
    rU, rV = oracle.stress2rhs(
        mesh.elem_nodes, mesh.node_elems, mesh.node_elems_pos,
        mesh.node_elems_num, **args,
    )
    masked_allclose(np.asarray(U), rU, msg="stress2rhs U")
    masked_allclose(np.asarray(V), rV, msg="stress2rhs V")


def test_f32_drift_bound_25_steps():
    """N-step (25) f32 drift vs the f64 path stays within the documented
    bound (PERF.md accuracy record; the eps-guarded b2 division is the
    sensitive op, reference kernels/fct_ale_b2.cu:10-11)."""
    mesh = generate_planar_mesh(preset="tiny")
    fields = random_fields(mesh, seed=0, dtype=np.float64)
    n = 25

    def run(dtype, eps):
        cfg = FctAleConfig(dt=0.5, iter_yn=True, dtype=dtype, flux_eps=eps)
        solver = FctAleSolver(mesh, cfg)
        return solver.run(solver.init_state(fields), n)

    ref = run(jnp.float64, 1e-16)
    f32 = run(jnp.float32, 1e-7)
    for k in ("fct_LO", "fct_adf_v", "fct_adf_h"):
        a = np.asarray(ref[k], np.float64)
        scale = max(np.abs(a).max(), 1.0)
        d = np.abs(np.asarray(f32[k], np.float64) - a).max() / scale
        assert d < 2e-5, f"f32[{k}] drift {d:.2e} after {n} steps"
