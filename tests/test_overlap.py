"""Comm/compute overlap evidence for the sharded step.

The reference hides its MPI wait behind node-local b3_vertical (inter_comm
phase, reference src/fesom2-accelerate.cu:342-356).  The sharded step keeps
that structure: the ``ppermute`` halo exchange of the limiter factors is
consumed only by b3-horizontal (and, through it, stage c), so a1..b2 and
b3-vertical do not depend on it.

These tests check that property at the dataflow level, stage by stage: in
the traced program, no equation traced under the ``jax.named_scope`` of a1,
a3, b1v, b1h, b2 or b3v may depend (transitively) on a ``ppermute``, while
b3h and c must.  XLA's scheduler is free to run an asynchronous collective
concurrently with any compute it does not feed, so dataflow independence is
the "overlap is possible" condition, checked without several GPUs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fesom2_accelerate_tpu.config import FctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver
from fesom2_accelerate_tpu.parallel import ShardedFctAleSolver


def _iter_eqns(jaxpr):
    """All eqns in a jaxpr, recursing into sub-jaxprs."""
    from jax._src.core import ClosedJaxpr, Jaxpr

    for eqn in jaxpr.eqns:
        yield jaxpr, eqn
        for v in eqn.params.values():
            sub = None
            if isinstance(v, ClosedJaxpr):
                sub = v.jaxpr
            elif isinstance(v, Jaxpr):
                sub = v
            if sub is not None:
                yield from _iter_eqns(sub)


def _find_body_jaxpr(jaxpr):
    """The (sub-)jaxpr that contains the ppermute eqns."""
    for owner, eqn in _iter_eqns(jaxpr):
        if eqn.primitive.name == "ppermute":
            return owner
    raise AssertionError("no ppermute found in the traced step")


def _stage_taint(jaxpr) -> dict:
    """{stage scope: [tainted?] per eqn} within the body jaxpr, where an
    eqn is tainted if it transitively consumes a ppermute's output."""
    from jax._src.core import Var

    body = _find_body_jaxpr(jaxpr)
    tainted = set()
    out = {}
    for eqn in body.eqns:
        hit = any(isinstance(v, Var) and v in tainted for v in eqn.invars)
        if hit or eqn.primitive.name == "ppermute":
            tainted.update(eqn.outvars)
        scope = str(eqn.source_info.name_stack).split("/")[0]
        out.setdefault(scope, []).append(hit)
    return out


def _solver(iter_yn, tracers=1):
    mesh = generate_planar_mesh(preset="small")
    cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=jnp.float32,
                       flux_eps=1e-7)
    sh = ShardedFctAleSolver(mesh, cfg, devices=jax.devices()[:4],
                             tracers=tracers)
    assert sh.exchange_mode == "ppermute"
    return sh


def _traced(sh, fields):
    state = sh.init_state(fields)
    return jax.make_jaxpr(sh._smapped)(sh.md, sh._hmaps, state).jaxpr


@pytest.fixture(scope="module", params=[False, True], ids=["noniter", "iter"])
def taint(request):
    mesh = generate_planar_mesh(preset="small")
    sh = _solver(request.param)
    return _stage_taint(_traced(sh, random_fields(mesh, seed=3,
                                                  dtype=np.float32)))


def test_pre_exchange_stages_independent(taint):
    """a1..b2 (the reference's pre_comm phase) run before the exchange."""
    for stage in ("a1", "a3", "b1v", "b1h", "b2"):
        assert stage in taint, f"no {stage} eqns traced: {sorted(taint)}"
        assert not any(taint[stage]), f"{stage} depends on the exchange"


def test_b3v_independent_of_exchange(taint):
    """b3-vertical (the inter_comm phase) can overlap the exchange."""
    assert "b3v" in taint
    assert not any(taint["b3v"]), "b3v depends on the exchange"


def test_b3h_depends_on_exchange(taint):
    """b3-horizontal consumes the exchanged limiter factors."""
    assert any(taint["b3h"]), "b3h must consume the exchanged factors"


def test_update_depends_on_exchange(taint):
    """Stage c consumes the limited fluxes b3h computed after the exchange."""
    assert any(taint["c"]), "stage c must follow the exchange"


def test_tracers_share_one_exchange_per_step():
    """Tb tracers vmapped per shard move their halos in the same number of
    ppermutes as one tracer (the batched collective carries all of them)."""
    mesh = generate_planar_mesh(preset="small")
    fields = random_fields(mesh, seed=3, dtype=np.float32)
    batched = {k: fields[k] for k in ("hnode", "hnode_new")}
    batched.update({k: np.stack([v, v]) for k, v in fields.items()
                    if k not in batched})

    def n_ppermute(jaxpr):
        return sum(e.primitive.name == "ppermute"
                   for _, e in _iter_eqns(jaxpr))

    one = n_ppermute(_traced(_solver(False), fields))
    two = n_ppermute(_traced(_solver(False, tracers=2), batched))
    assert one > 0 and two == one, (one, two)


def test_overlap_step_exact_vs_serial():
    """The overlapped schedule computes what the single-device step
    computes (owned columns)."""
    mesh = generate_planar_mesh(preset="small")
    fields = random_fields(mesh, seed=11, dtype=np.float32)
    cfg = FctAleConfig(dt=0.7, dtype=jnp.float32, flux_eps=1e-7)
    ref = FctAleSolver(mesh, cfg)
    ref_out = ref.step(ref.init_state(fields))
    sh = ShardedFctAleSolver(mesh, cfg)
    out = sh.step(sh.init_state(fields))
    for k in ("fct_plus", "fct_minus", "fct_adf_v", "del_ttf_advhoriz"):
        got = sh.gather_node(out[k])
        refv = np.asarray(ref_out[k])
        err = np.abs(got - refv).max() / max(np.abs(refv).max(), 1.0)
        assert err < 2e-6, f"{k} relerr {err:.2e}"
