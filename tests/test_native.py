"""Native C++ core vs Python implementations.

The C++ library is a second, independent implementation of both the topology
derivation and the pinned FCT-ALE semantics — agreement with the numpy side
is part of the semantics gate."""

import numpy as np
import pytest

from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu.mesh import native
from fesom2_accelerate_tpu.ops import oracle

from conftest import masked_allclose

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no compiler)"
)


def test_native_edges_match(small_mesh):
    m = small_mesh
    edges, edge_tri = native.build_edges(m.elem_nodes)
    np.testing.assert_array_equal(edges, m.edges)
    np.testing.assert_array_equal(edge_tri, m.edge_tri)


def test_native_ragged_match(small_mesh):
    m = small_mesh
    rows = m.elem_nodes.ravel()
    cols = np.repeat(np.arange(m.n_elems, dtype=np.int32), 3)
    pos = np.tile(np.arange(3, dtype=np.int32), m.n_elems)
    padded, counts, extra = native.ragged_to_padded(
        rows, cols, m.n_nodes, extra=pos
    )
    np.testing.assert_array_equal(padded, m.node_elems)
    np.testing.assert_array_equal(counts, m.node_elems_num)
    np.testing.assert_array_equal(extra, m.node_elems_pos)


@pytest.mark.parametrize("iter_yn", [False, True])
def test_native_reference_matches_oracle(small_mesh, iter_yn):
    m = small_mesh
    fields = random_fields(m, seed=5)
    ref = native.NativeReference(m)
    out_c = ref.step(fields, dt=0.7, iter_yn=iter_yn)
    out_py = oracle.fct_ale_step(m, fields, vlimit=1, iter_yn=iter_yn, dt=0.7)
    for k in out_py:
        masked_allclose(out_c[k], out_py[k], rtol=1e-12, atol=1e-12,
                        msg=f"native[{k}] iter={iter_yn}")


def test_native_stress2rhs(small_mesh):
    import ctypes

    m = small_mesh
    lib = native.load()
    rng = np.random.default_rng(9)
    E, N = m.n_elems, m.n_nodes
    elem_area = np.abs(rng.standard_normal(E)) + 0.1
    ice_strength = rng.standard_normal(E)
    s11, s12, s22 = rng.standard_normal((3, E))
    grad = rng.standard_normal((6, E))
    mf = rng.standard_normal(E)
    iam = rng.standard_normal(N)
    rhs_a, rhs_m = rng.standard_normal((2, N))
    U = np.empty(N)
    V = np.empty(N)

    def p(a):
        return np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)

    en = np.ascontiguousarray(m.elem_nodes, np.int32)
    args = [ctypes.c_int64(N), ctypes.c_int64(E),
            en.ctypes.data_as(ctypes.c_void_p)]
    holders = [np.ascontiguousarray(x, np.float64) for x in
               (elem_area, ice_strength, s11, s12, s22, grad, mf, iam,
                rhs_a, rhs_m, U, V)]
    lib.f2t_stress2rhs(*args, *[h.ctypes.data_as(ctypes.c_void_p)
                                for h in holders])
    U, V = holders[-2], holders[-1]
    rU, rV = oracle.stress2rhs(
        m.elem_nodes, m.node_elems, m.node_elems_pos, m.node_elems_num,
        elem_area, ice_strength, s11, s12, s22, grad, mf, iam, rhs_a, rhs_m,
    )
    masked_allclose(U, rU, msg="native stress2rhs U")
    masked_allclose(V, rV, msg="native stress2rhs V")


def _build_host_demo():
    """Build the host-embedding shim + demo driver (make host)."""
    import pathlib
    import subprocess

    native_dir = pathlib.Path(__file__).resolve().parents[1] / "native"
    demo = native_dir / "build" / "host_embed_demo"
    try:
        subprocess.run(["make", "-C", str(native_dir), "host"], check=True,
                       capture_output=True, timeout=240)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired):
        return None
    return demo if demo.exists() else None


@pytest.mark.parametrize("iter_yn,backend", [(False, 0), (True, 0),
                                             (False, 1), (True, 1)])
def test_host_embedding_abi_matches_solver(tmp_path, iter_yn, backend):
    """The Fortran/C-callable embedding ABI (native/fesom2_tpu_host.cpp —
    the reference-L1 analogue, reference include/fesom2-accelerate.h:
    128-236) drives one FCT-ALE step from a pure-C host program and
    matches the in-process f64 solver bit-exactly.

    The demo binary owns every array in C memory and talks to the
    framework only through f2t_init_/f2t_setup_/f2t_dims_/
    f2t_fct_ale_step_ — a real embedding, not a Python round-trip."""
    import os
    import subprocess
    import sysconfig

    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver

    demo = _build_host_demo()
    if demo is None:
        pytest.skip("host embedding shim unavailable (no compiler/libpython)")

    mesh = generate_planar_mesh(preset="toy")
    fields = random_fields(mesh, seed=5)
    # backend 0 = the f64 step (bit-exact vs the in-process f64 solver);
    # backend 1 = the f32 step, compared with the in-process f32 solver
    if backend == 0:
        cfg = FctAleConfig(dt=0.5, vlimit=1, iter_yn=iter_yn,
                           dtype=jnp.float64)
    else:
        cfg = FctAleConfig(dt=0.5, vlimit=1, iter_yn=iter_yn,
                           dtype=jnp.float32, flux_eps=1e-7)
    solver = FctAleSolver(mesh, cfg)
    ref = solver.step(solver.init_state(fields))

    d = tmp_path
    L, N, Ed, E = mesh.n_layers, mesh.n_nodes, mesh.n_edges, mesh.n_elems
    (d / "meta.txt").write_text(
        f"{E} {mesh.nl} {N} 500 1 {int(iter_yn)} {backend}\n")
    mesh.elem_nodes.astype(np.int32).tofile(d / "elem_nodes.bin")
    mesh.nlev_elem.astype(np.int32).tofile(d / "nlev_elem.bin")
    mesh.node_xy.astype(np.float64).tofile(d / "node_xy.bin")
    for k, n in [("ttf", "ttf"), ("fct_LO", "fct_LO"),
                 ("fct_adf_v", "adf_v"), ("fct_adf_h", "adf_h"),
                 ("hnode", "hnode"), ("hnode_new", "hnode_new"),
                 ("del_ttf_advvert", "del_v"),
                 ("del_ttf_advhoriz", "del_h")]:
        np.asarray(fields[k], np.float64).tofile(d / f"{n}.bin")

    # the embedded interpreter is the build python (python3-config) — point
    # it at the framework and this venv's site-packages
    import fesom2_accelerate_tpu

    repo = os.path.dirname(os.path.dirname(fesom2_accelerate_tpu.__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo, sysconfig.get_paths()["purelib"]])
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run([str(demo), str(d)], capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode == 0, f"demo failed:\n{p.stdout}\n{p.stderr[-3000:]}"

    checks = [("fct_adf_v", "out_adf_v", (L + 1, N)),
              ("fct_adf_h", "out_adf_h", (L, Ed))]
    if iter_yn:
        checks.append(("fct_LO", "out_fct_LO", (L, N)))
    else:
        checks += [("del_ttf_advvert", "out_del_v", (L, N)),
                   ("del_ttf_advhoriz", "out_del_h", (L, N))]
    for k, n, shape in checks:
        got = np.fromfile(d / f"{n}.bin").reshape(shape)
        refv = np.asarray(ref[k])
        if backend == 0:
            np.testing.assert_array_equal(got, refv,
                                          err_msg=f"host-embed[{k}]")
        else:
            err = np.abs(got - refv).max() / max(np.abs(refv).max(), 1.0)
            assert err < 2e-6, f"host-embed-f32[{k}] relerr {err:.2e}"
