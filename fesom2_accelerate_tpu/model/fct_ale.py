"""Single-device FCT-ALE solver driver.

The device-resident counterpart of the reference's orchestration layer
(src/fesom2-accelerate.cu:258-379) — but where the reference splits the chain
into pre/inter/post-comm phases with per-variable H2D/D2H transfers and
stream/event ordering, here the whole step is ONE jitted function on
device-resident state: the reference's per-step transfer overhead
(src/fesom2-accelerate.cu:268,338-339,355,364-365,378) has no equivalent.

The phase split survives as three composable functions (``pre_comm``,
``inter_comm``, ``post_comm``) because the multi-device path
(fesom2_accelerate_tpu.parallel) inserts the halo exchange between them,
exactly where host FESOM2 calls ``exchange_nod`` (docs/refactoring.md:200,235).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from fesom2_accelerate_tpu.config import FctAleConfig
from fesom2_accelerate_tpu.mesh.topology import Mesh
from fesom2_accelerate_tpu.ops import stages
from fesom2_accelerate_tpu.ops.meshdata import MeshData, build_mesh_data


def pre_comm(md: MeshData, cfg: FctAleConfig, ttf, fct_LO, fct_adf_v,
             fct_adf_h):
    """Stages a1..b2 -> limiter factors (reference
    fct_ale_pre_comm_acc_, src/fesom2-accelerate.cu:258-340)."""
    tmax, tmin = stages.a1(md, fct_LO, ttf)
    if cfg.vlimit == 1:
        # fused a2+a3: the element-cluster reduce collapses to a node-
        # neighbor max over incident edges (see stages.a3_vlimit1_fused) —
        # no UV array is ever materialized.  Exact for |values| < bignumber,
        # which is the reference's own padding assumption.
        tmax2, tmin2 = stages.a3_vlimit1_fused(md, tmax, tmin, fct_LO)
    else:
        UV_max, UV_min = stages.a2(md, tmax, tmin, cfg.bignumber)
        tmax2, tmin2 = stages.a3(md, UV_max, UV_min, tmax, fct_LO,
                                 cfg.vlimit)
    fct_plus, fct_minus = stages.b1_vertical(md, fct_adf_v)
    fct_plus, fct_minus = stages.b1_horizontal(
        md, fct_plus, fct_minus, fct_adf_h
    )
    fct_plus, fct_minus = stages.b2(
        md, fct_plus, fct_minus, tmax2, tmin2, cfg.dt, cfg.flux_eps
    )
    return dict(
        fct_ttf_max=tmax2, fct_ttf_min=tmin2,
        fct_plus=fct_plus, fct_minus=fct_minus,
    )


def inter_comm(md: MeshData, cfg: FctAleConfig, fct_plus, fct_minus,
               fct_adf_v):
    """b3 vertical — node-local work the reference overlaps with the MPI
    wait (fct_ale_inter_comm_acc_, src/fesom2-accelerate.cu:342-356)."""
    return stages.b3_vertical(md, fct_plus, fct_minus, fct_adf_v, cfg.iter_yn)


def post_comm(md: MeshData, cfg: FctAleConfig, fct_plus, fct_minus,
              fct_adf_h):
    """b3 horizontal, after exchanged limiter factors are available
    (fct_ale_post_comm_acc_, src/fesom2-accelerate.cu:358-379)."""
    return stages.b3_horizontal(
        md, fct_plus, fct_minus, fct_adf_h, cfg.iter_yn
    )


def fct_ale_step(md: MeshData, cfg: FctAleConfig, state: dict) -> dict:
    """Full a->b->c chain on one device.  ``state`` carries the field dict of
    :func:`fesom2_accelerate_tpu.mesh.generate.random_fields`."""
    lim = pre_comm(md, cfg, state["ttf"], state["fct_LO"],
                   state["fct_adf_v"], state["fct_adf_h"])
    fct_plus, fct_minus = lim["fct_plus"], lim["fct_minus"]
    adf_v, adf_v2 = inter_comm(md, cfg, fct_plus, fct_minus,
                               state["fct_adf_v"])
    adf_h, adf_h2 = post_comm(md, cfg, fct_plus, fct_minus,
                              state["fct_adf_h"])

    out = dict(state)
    out.update(
        fct_ttf_max=lim["fct_ttf_max"], fct_ttf_min=lim["fct_ttf_min"],
        fct_plus=fct_plus, fct_minus=fct_minus,
    )
    if cfg.iter_yn:
        new_LO = stages.c_update_LO(
            md, state["fct_LO"], adf_v, adf_h, state["hnode_new"], cfg.dt
        )
        # swap in the residual fluxes for the next FCT iteration
        # (docs/refactoring.md:287-289)
        out.update(
            fct_LO=new_LO, fct_adf_v=adf_v2, fct_adf_h=adf_h2,
            fct_adf_v_limited=adf_v, fct_adf_h_limited=adf_h,
        )
    else:
        del_v, del_h = stages.c_update_solution(
            md, state["ttf"], state["hnode"], state["hnode_new"],
            state["fct_LO"], adf_v, adf_h,
            state["del_ttf_advvert"], state["del_ttf_advhoriz"], cfg.dt,
        )
        out.update(
            fct_adf_v=adf_v, fct_adf_h=adf_h,
            del_ttf_advvert=del_v, del_ttf_advhoriz=del_h,
        )
    return out


# State fields every tracer of a timestep shares; all others are per tracer.
_SHARED = ("hnode", "hnode_new")


def vmap_tracers(step, state: dict) -> dict:
    """``step(state) -> dict`` vmapped over the leading tracer axis of every
    per-tracer field; ``hnode``/``hnode_new`` are shared [L, N] arrays and
    come back unbatched.  A collective inside ``step`` is batched too, so
    one exchange moves every tracer's halo."""
    shared = {k: state[k] for k in _SHARED if k in state}
    per = {k: v for k, v in state.items() if k not in shared}

    def one(p):
        out = step({**p, **shared})
        return {k: v for k, v in out.items() if k not in shared}

    return {**jax.vmap(one)(per), **shared}


def fct_ale_step_tracers(md: MeshData, cfg: FctAleConfig, state: dict) -> dict:
    """:func:`fct_ale_step` over a leading tracer axis (see
    :func:`vmap_tracers`)."""
    return vmap_tracers(lambda s: fct_ale_step(md, cfg, s), state)


class FctAleSolver:
    """Owns the device-resident mesh data and the jitted step.

    Usage::

        solver = FctAleSolver(mesh, FctAleConfig(dtype=jnp.float32))
        state = solver.init_state(fields)      # host numpy -> device
        state = solver.step(state)             # one FCT-ALE step
        state = solver.run(state, n_steps=10)  # lax.scan'd iteration

    The step is the jnp stage chain (:mod:`fesom2_accelerate_tpu.ops.stages`)
    compiled by XLA, in any float dtype."""

    def __init__(self, mesh: Mesh, cfg: FctAleConfig = FctAleConfig()):
        self.mesh = mesh
        self.cfg = cfg
        # mesh data is passed as a jit ARGUMENT, never closed over:
        # closure-captured device arrays are inlined into the HLO as literal
        # constants, which slows compilation and adds dispatch overhead
        self.md = build_mesh_data(mesh, dtype=cfg.dtype)
        c = self.cfg
        self._step_fn = lambda md, state: fct_ale_step(md, c, state)
        self._tracer_fn = lambda md, state: fct_ale_step_tracers(md, c, state)
        self._step = jax.jit(self._step_fn)
        self._step_tracers = jax.jit(self._tracer_fn)
        self._scan_cache = {}

    def init_state(self, fields: dict) -> dict:
        return {
            k: jnp.asarray(v, dtype=self.cfg.dtype) for k, v in fields.items()
        }

    def step(self, state: dict) -> dict:
        return self._step(self.md, state)

    def _scan(self, step_fn, n_steps: int):
        @jax.jit
        def scan_steps(md, s):
            def body(c, _):
                new = step_fn(md, c)
                # carry keeps the input structure: drop diagnostics
                return {k: new[k] for k in c}, None

            s, _ = jax.lax.scan(body, s, None, length=n_steps)
            return s

        return scan_steps

    def run(self, state: dict, n_steps: int) -> dict:
        """n_steps of the step function under lax.scan (on-device loop)."""
        key = ("single", n_steps)
        if key not in self._scan_cache:
            self._scan_cache[key] = self._scan(self._step_fn, n_steps)
        return self._scan_cache[key](self.md, state)

    # ---- multi-tracer batching ---------------------------------------------
    # The host model advects many tracers per timestep over one mesh; the
    # reference runs one full library call per tracer (reference
    # include/fesom2-accelerate.h:213-236).  Here Tb tracers run through one
    # compiled step, ``jax.vmap`` of the single-tracer chain: per-tracer
    # fields carry a leading [Tb] axis, ``hnode``/``hnode_new`` are shared.

    # multi-tracer state (per-tracer fields [Tb, ...], shared
    # hnode/hnode_new [L, N]) uploads like single-tracer state
    init_state_tracers = init_state

    def step_tracers(self, state: dict) -> dict:
        """One step on multi-tracer state; natural shapes in and out."""
        return self._step_tracers(self.md, state)

    def run_tracers(self, state: dict, n_steps: int) -> dict:
        """n_steps of the batched step under lax.scan."""
        key = ("tracers", n_steps)
        if key not in self._scan_cache:
            self._scan_cache[key] = self._scan(self._tracer_fn, n_steps)
        return self._scan_cache[key](self.md, state)
