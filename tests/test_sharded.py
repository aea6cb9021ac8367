"""Sharded (8 virtual devices) vs single-device FCT-ALE: the multi-domain
contract the reference never tested in-repo (SURVEY §4.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fesom2_accelerate_tpu.config import FctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver
from fesom2_accelerate_tpu.parallel import ShardedFctAleSolver, partition_mesh
from fesom2_accelerate_tpu.parallel import partition as part_mod

from conftest import masked_allclose


@pytest.fixture(scope="module")
def setup():
    mesh = generate_planar_mesh(preset="small")
    fields = random_fields(mesh, seed=3)
    return mesh, fields


def test_partition_covers_mesh(setup):
    mesh, _ = setup
    pm = partition_mesh(mesh, 4)
    # every node owned exactly once
    owned_all = np.concatenate([
        pm.local_nodes_global[p, pm.H : pm.H + pm.owned_count[p]]
        for p in range(pm.n_parts)
    ])
    assert sorted(owned_all.tolist()) == list(range(mesh.n_nodes))
    # halo sources point at the right global nodes ([H | owned | H] layout)
    H, B = pm.H, pm.B
    for p in range(pm.n_parts):
        h1, h2 = pm.halo_lo_count[p], pm.halo_hi_count[p]
        for h in range(h1):
            pos = H - h1 + h
            gid = pm.local_nodes_global[p, pos]
            src = pm.halo_lo_src_part[p, pos]
            idx = pm.halo_lo_src_idx[p, pos]
            assert pm.local_nodes_global[src, H + idx] == gid
        for h in range(h2):
            gid = pm.local_nodes_global[p, H + B + h]
            src = pm.halo_hi_src_part[p, h]
            idx = pm.halo_hi_src_idx[p, h]
            assert pm.local_nodes_global[src, H + idx] == gid


def _simulate_hop_exchange(pm, field):
    """Numpy re-enactment of step_sharded._halo_fill_nbr on a global node
    field: pack per-hop send slabs, shift them r parts, land via the
    (hop, pos) maps.  Returns the per-part halo columns it reconstructs."""
    P, H, B = pm.n_parts, pm.H, pm.B
    own = np.zeros((P, B), field.dtype)
    for p in range(P):
        no = pm.owned_count[p]
        own[p, :no] = field[pm.local_nodes_global[p, H:H + no]]
    lo = np.zeros((P, H), field.dtype)
    hi = np.zeros((P, H), field.dtype)
    for r in range(1, pm.neighbor_radius + 1):
        up = own[np.arange(P)[:, None], pm.hop_send_up[r - 1]]
        dn = own[np.arange(P)[:, None], pm.hop_send_dn[r - 1]]
        rup = np.zeros_like(up)
        rup[r:] = up[:-r]  # recv from p-r
        rdn = np.zeros_like(dn)
        rdn[:-r] = dn[r:]  # recv from p+r
        sel = pm.halo_lo_hop == r
        lo[sel] = rup[np.arange(P)[:, None],
                      np.minimum(pm.halo_lo_pos, up.shape[1] - 1)][sel]
        sel = pm.halo_hi_hop == r
        hi[sel] = rdn[np.arange(P)[:, None],
                      np.minimum(pm.halo_hi_pos, dn.shape[1] - 1)][sel]
    return lo, hi


def _check_hop_exchange(mesh, n_parts, expect_radius=None):
    pm = partition_mesh(mesh, n_parts)
    if expect_radius is not None:
        assert pm.neighbor_radius >= expect_radius, pm.neighbor_radius
    rng = np.random.default_rng(3)
    field = rng.standard_normal(mesh.n_nodes)
    lo, hi = _simulate_hop_exchange(pm, field)
    H, B = pm.H, pm.B
    for p in range(pm.n_parts):
        h1, h2 = pm.halo_lo_count[p], pm.halo_hi_count[p]
        want_lo = field[pm.local_nodes_global[p, H - h1:H]]
        np.testing.assert_array_equal(lo[p, H - h1:], want_lo)
        want_hi = field[pm.local_nodes_global[p, H + B:H + B + h2]]
        np.testing.assert_array_equal(hi[p, :h2], want_hi)
        assert pm.halo_lo_mask[p].sum() == h1
        assert pm.halo_hi_mask[p].sum() == h2
    # comm volume ~ halo, not P*B: per-hop slab widths sum to O(H)
    total_w = sum(a.shape[1] for a in pm.hop_send_up + pm.hop_send_dn)
    assert total_w <= 2 * pm.H + 2 * pm.neighbor_radius


def test_partition_neighbor_send_lists(setup):
    """Hop-1 packed ppermute send lists reproduce each neighbor's halo."""
    mesh, _ = setup
    pm = partition_mesh(mesh, 8)
    assert pm.neighbor_only and pm.neighbor_radius == 1
    _check_hop_exchange(mesh, 8)


def test_partition_multihop_send_lists():
    """Block size < mesh bandwidth: halos span several stripes and the
    exchange needs radius > 1 — the packed multi-hop path must still
    reconstruct every halo column exactly, with comm ~ halo (the failure
    mode the round-1 all-gather fallback degraded to P*B on)."""
    mesh = generate_planar_mesh(nx=4, ny=7, nl=5)
    _check_hop_exchange(mesh, 8, expect_radius=2)


def test_sharded_multihop_matches_single():
    """End-to-end sharded step over a radius>1 partition (block size <
    bandwidth) is exact vs the single-device solver — the per-neighbor
    packed exchange path, not the all-gather fallback."""
    mesh = generate_planar_mesh(nx=4, ny=7, nl=5)
    fields = random_fields(mesh, seed=2)
    cfg = FctAleConfig(dt=0.7, dtype=jnp.float64)
    ref_solver = FctAleSolver(mesh, cfg)
    ref_out = ref_solver.step(ref_solver.init_state(fields))

    sh = ShardedFctAleSolver(mesh, cfg, exchange="ppermute")
    assert sh.pm.neighbor_radius >= 2
    out = sh.step(sh.init_state(fields))
    for k in ("fct_plus", "fct_minus", "del_ttf_advvert",
              "del_ttf_advhoriz"):
        masked_allclose(sh.gather_node(out[k]), np.asarray(ref_out[k]),
                        msg=k)


def test_scatter_gather_roundtrip(setup):
    mesh, fields = setup
    pm = partition_mesh(mesh, 4)
    loc = part_mod.scatter_node_field(pm, fields["ttf"])
    back = part_mod.gather_node_field(pm, loc)
    np.testing.assert_array_equal(back, fields["ttf"])


@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_sharded_matches_single(setup, iter_yn, exchange):
    mesh, fields = setup
    cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=jnp.float64)

    ref_solver = FctAleSolver(mesh, cfg)
    ref_out = ref_solver.step(ref_solver.init_state(fields))

    sh = ShardedFctAleSolver(mesh, cfg, exchange=exchange)
    assert sh.n_parts == 8
    assert sh.exchange_mode == exchange
    out = sh.step(sh.init_state(fields))

    node_keys = ["fct_plus", "fct_minus", "fct_ttf_max", "fct_ttf_min"]
    node_keys += (
        ["fct_LO"] if iter_yn else ["del_ttf_advvert", "del_ttf_advhoriz"]
    )
    for k in node_keys:
        got = sh.gather_node(out[k])
        masked_allclose(got, np.asarray(ref_out[k]), rtol=1e-12, atol=1e-12,
                        msg=f"sharded[{k}] iter={iter_yn}")
    # vertical fluxes are node fields too (interface layout)
    got = sh.gather_node(out["fct_adf_v"])
    masked_allclose(got, np.asarray(ref_out["fct_adf_v"]), rtol=1e-12,
                    atol=1e-12, msg="sharded[fct_adf_v]")


@pytest.mark.parametrize("vlimit", [2, 3])
def test_sharded_vlimit23_matches_single(setup, vlimit):
    """vlimit 2/3 (the variants the reference implemented only in its
    Fortran spec, docs/refactoring.md:113-148) through the sharded path."""
    mesh, fields = setup
    cfg = FctAleConfig(dt=0.7, vlimit=vlimit, dtype=jnp.float64)

    ref_solver = FctAleSolver(mesh, cfg)
    ref_out = ref_solver.step(ref_solver.init_state(fields))

    sh = ShardedFctAleSolver(mesh, cfg)
    out = sh.step(sh.init_state(fields))
    for k in ("fct_plus", "fct_minus", "fct_ttf_max", "fct_ttf_min",
              "del_ttf_advvert", "del_ttf_advhoriz"):
        got = sh.gather_node(out[k])
        masked_allclose(got, np.asarray(ref_out[k]), rtol=1e-12, atol=1e-12,
                        msg=f"sharded-vlimit{vlimit}[{k}]")


def test_sharded_multistep(setup):
    """Iterative mode carries fct_LO across steps through the halo refresh."""
    mesh, fields = setup
    cfg = FctAleConfig(dt=0.3, iter_yn=True, dtype=jnp.float64)
    n_steps = 3

    ref_solver = FctAleSolver(mesh, cfg)
    ref_state = ref_solver.run(ref_solver.init_state(fields), n_steps)

    sh = ShardedFctAleSolver(mesh, cfg)
    state = sh.run(sh.init_state(fields), n_steps)

    masked_allclose(sh.gather_node(state["fct_LO"]),
                    np.asarray(ref_state["fct_LO"]),
                    rtol=1e-11, atol=1e-12, msg="fct_LO after steps")
    masked_allclose(sh.gather_node(state["fct_adf_v"]),
                    np.asarray(ref_state["fct_adf_v"]),
                    rtol=1e-11, atol=1e-12, msg="fct_adf_v after steps")


@pytest.mark.parametrize("iter_yn", [False, True])
def test_sharded_tracers_match_single(setup, iter_yn):
    """Multi-tracer batching composed with domain decomposition: Tb
    tracers vmapped per shard, one batched exchange moving every tracer's
    halo per step — each tracer must match the single-device step."""
    mesh, fields = setup
    Tb = 2
    cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=jnp.float64)
    per = [fields] + [random_fields(mesh, seed=50 + t) for t in range(1, Tb)]
    for t in range(1, Tb):
        per[t].update({k: fields[k] for k in ("hnode", "hnode_new")})
    refs = []
    for t in range(Tb):
        solver = FctAleSolver(mesh, cfg)
        refs.append(solver.step(solver.init_state(per[t])))

    batched = {k: fields[k] for k in ("hnode", "hnode_new")}
    for k in fields:
        if k not in batched:
            batched[k] = np.stack([f[k] for f in per])
    sh = ShardedFctAleSolver(mesh, cfg, tracers=Tb)
    out = sh.step(sh.init_state(batched))

    keys = ["fct_plus", "fct_minus", "fct_adf_v"]
    keys += (["fct_LO"] if iter_yn
             else ["del_ttf_advvert", "del_ttf_advhoriz"])
    for k in keys:
        got = sh.gather_node(out[k])
        for t in range(Tb):
            masked_allclose(got[t], np.asarray(refs[t][k]),
                            msg=f"sharded-tracers[{k}][t={t}]")

    # gather_state (the checkpoint path) is tracer-aware: init fields
    # round-trip through the batched layout
    g = sh.gather_state(sh.init_state(batched))
    for k in ("ttf", "fct_adf_h"):
        for t in range(Tb):
            np.testing.assert_array_equal(
                np.asarray(g[k][t]), per[t][k],
                err_msg=f"gather_state[{k}][t={t}]")


def test_init_state_puts_each_part_on_its_device(setup):
    """init_state builds the per-part stacks on the host and sends each
    shard straight to its device: every field comes back sharded over the
    part axis, one [1, ...] block per device, in partition order."""
    mesh, fields = setup
    cfg = FctAleConfig(dt=0.7, dtype=jnp.float64)
    devices = jax.devices()[:4]
    sh = ShardedFctAleSolver(mesh, cfg, devices=devices)
    state = sh.init_state(fields)
    for k, v in state.items():
        assert v.shape[0] == 4
        shards = sorted(v.addressable_shards, key=lambda x: x.index[0].start)
        assert [s.device for s in shards] == list(devices), k
        assert all(s.data.shape[0] == 1 for s in shards), k
