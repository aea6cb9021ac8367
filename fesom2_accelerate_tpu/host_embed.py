"""Host-embedding surface: the Python side of the native C ABI.

The reference's L1 is a Fortran-callable C ABI that mirrors host arrays
into GPU memory and drives the production pipeline (reference
include/fesom2-accelerate.h:128-236, src/fesom2-accelerate.cu:258-379).
Here it is split in two:

* ``native/fesom2_tpu_host.cpp`` — the ``extern "C"`` surface a Fortran/C
  host links against (``f2t_init_``, ``f2t_setup_``, ``f2t_dims_``,
  ``f2t_fct_ale_step_``, ``f2t_finalize_``).  It embeds CPython and calls
  this module.
* this module — wraps the caller's raw host pointers as numpy views
  (zero-copy), builds the Mesh/solver once at setup (the analogue of the
  reference's one-time ``transfer_mesh_`` upload), and per step uploads
  the input fields, runs the jitted step, and writes results back into
  the caller's buffers (the analogue of ``transfer_var_``/
  ``transfer_back``).

All functions take ONLY ints (sizes, flags) and addresses (``intptr_t``
pointer values) so the C side needs nothing beyond
``PyObject_CallMethod`` with an integer format string.  Connectivity is
0-based (documented deviation from the reference's 1-based Fortran
indices — there is no Fortran host here to inherit them from).
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["setup", "dims", "step", "reset"]

_SOLVER = None
_MESH = None
_CFG = None
_STATE_KEYS = ("ttf", "fct_LO", "fct_adf_v", "fct_adf_h", "hnode",
               "hnode_new", "del_ttf_advvert", "del_ttf_advhoriz")


def _view(addr: int, shape, dtype):
    """Zero-copy numpy view of caller-owned host memory."""
    n = int(np.prod(shape))
    ctype = {"float64": ctypes.c_double, "int32": ctypes.c_int32}[
        np.dtype(dtype).name]
    buf = (ctype * n).from_address(int(addr))
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def setup(n_elems: int, nl: int, elem_nodes_addr: int, nlev_elem_addr: int,
          n_nodes: int, node_xy_addr: int, dt_milli: int, vlimit: int,
          iter_yn: int, backend: int) -> int:
    """Build the mesh + solver from host connectivity (one-time, like the
    reference's ``transfer_mesh_`` + ``alloc_var_`` phase).

    backend: 0 = f64 step (the reference's ``real_type = double``),
    1 = f32 step (``flux_eps`` rescaled to 1e-7).  Both run the XLA stage
    chain on whatever device JAX uses.
    dt_milli: timestep in 1e-3 units (the ABI passes integers only).
    Returns 0 on success, 1 on failure (mirrors the reference's ``istat``
    error propagation, src/fesom2-accelerate.cu:114-127)."""
    global _SOLVER, _MESH, _CFG
    try:
        import jax.numpy as jnp

        from fesom2_accelerate_tpu.config import FctAleConfig
        from fesom2_accelerate_tpu.mesh.topology import (
            build_mesh_from_elements,
        )
        from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver

        elem_nodes = _view(elem_nodes_addr, (n_elems, 3), np.int32).copy()
        nlev_elem = _view(nlev_elem_addr, (n_elems,), np.int32).copy()
        node_xy = _view(node_xy_addr, (n_nodes, 2), np.float64).copy()
        mesh = build_mesh_from_elements(elem_nodes, nlev_elem, nl, node_xy)
        mesh.validate()
        if backend == 1:
            cfg = FctAleConfig(dt=dt_milli * 1e-3, vlimit=vlimit,
                               iter_yn=bool(iter_yn), dtype=jnp.float32,
                               flux_eps=1e-7)
        else:
            import jax

            jax.config.update("jax_enable_x64", True)
            cfg = FctAleConfig(dt=dt_milli * 1e-3, vlimit=vlimit,
                               iter_yn=bool(iter_yn), dtype=jnp.float64)
        solver = FctAleSolver(mesh, cfg)
        _SOLVER, _MESH, _CFG = solver, mesh, cfg
        return 0
    except Exception:
        import traceback

        traceback.print_exc()
        return 1


def dims() -> tuple:
    """(n_nodes, n_edges, n_layers): edge count is derived on our side
    (the host sizes its flux buffers from this, where the reference's
    host already knew myDim_edge2D)."""
    return (int(_MESH.n_nodes), int(_MESH.n_edges), int(_MESH.n_layers))


def step(ttf_a: int, lo_a: int, adf_v_a: int, adf_h_a: int, hnode_a: int,
         hnode_new_a: int, del_v_a: int, del_h_a: int) -> int:
    """One FCT-ALE step on host-owned f64 buffers (level-major: [L, N]
    node fields, [L+1, N] interface fluxes, [L, Ed] edge fluxes).

    In/out contract (matches the reference phase drivers' read-backs,
    src/fesom2-accelerate.cu:338-378, plus the stage-c outputs its L2
    never wired): ``fct_adf_v``/``fct_adf_h`` are overwritten with the
    limited fluxes; non-iterative mode accumulates into ``del_v``/
    ``del_h``; iterative mode overwrites ``fct_LO`` and leaves the
    residual fluxes in ``fct_adf_v``/``fct_adf_h``."""
    try:
        L, N, Ed = _MESH.n_layers, _MESH.n_nodes, _MESH.n_edges
        views = dict(
            ttf=_view(ttf_a, (L, N), np.float64),
            fct_LO=_view(lo_a, (L, N), np.float64),
            fct_adf_v=_view(adf_v_a, (L + 1, N), np.float64),
            fct_adf_h=_view(adf_h_a, (L, Ed), np.float64),
            hnode=_view(hnode_a, (L, N), np.float64),
            hnode_new=_view(hnode_new_a, (L, N), np.float64),
            del_ttf_advvert=_view(del_v_a, (L, N), np.float64),
            del_ttf_advhoriz=_view(del_h_a, (L, N), np.float64),
        )
        state = _SOLVER.init_state({k: v.copy() for k, v in views.items()})
        out = _SOLVER.step(state)
        np.copyto(views["fct_adf_v"], np.asarray(out["fct_adf_v"],
                                                 np.float64))
        np.copyto(views["fct_adf_h"], np.asarray(out["fct_adf_h"],
                                                 np.float64))
        if _CFG.iter_yn:
            np.copyto(views["fct_LO"], np.asarray(out["fct_LO"], np.float64))
        else:
            np.copyto(views["del_ttf_advvert"],
                      np.asarray(out["del_ttf_advvert"], np.float64))
            np.copyto(views["del_ttf_advhoriz"],
                      np.asarray(out["del_ttf_advhoriz"], np.float64))
        return 0
    except Exception:
        import traceback

        traceback.print_exc()
        return 1


def reset() -> int:
    global _SOLVER, _MESH, _CFG
    _SOLVER = _MESH = _CFG = None
    return 0
