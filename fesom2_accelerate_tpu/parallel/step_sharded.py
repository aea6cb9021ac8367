"""Multi-device FCT-ALE step: shard_map over a device mesh with halo exchange.

The step keeps the reference's three-phase structure
(src/fesom2-accelerate.cu:258,342,358) but the host MPI ``exchange_nod`` of
``fct_plus``/``fct_minus`` (docs/refactoring.md:199-200,235) becomes an XLA
collective inside ``shard_map``:

    pre_comm (a1..b2, local)  ->  exchange(owned limiter columns)
                                   || b3_vertical (node-local work that does
                                   ||   not consume the collective, like the
                                   ||   reference's inter_comm phase)
    halo columns filled       ->  b3_horizontal, stage c (local)

The collective result is consumed only by b3_horizontal, so XLA's scheduler
is free to run the exchange concurrently with node-local work.  Each shard
runs the jnp stage chain (any float dtype); ``tracers > 1`` vmaps it over a
leading tracer axis, and the batched collective still moves every tracer's
halo in one exchange per step.

Two exchange primitives (SURVEY §2.6 "halo-exchange communication"):

* ``ppermute`` (default when the partition is neighbor-only, which holds
  whenever block size >= mesh bandwidth): packed send lists + one-hop
  shifts between neighbouring devices — comm volume 2H per part, the direct
  analogue of the host's point-to-point ``exchange_nod``;
* ``allgather`` fallback for pathological partitions (comm volume P*B).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from fesom2_accelerate_tpu.config import FctAleConfig
from fesom2_accelerate_tpu.mesh.topology import Mesh
from fesom2_accelerate_tpu.model import fct_ale as single
from fesom2_accelerate_tpu.ops import stages
from fesom2_accelerate_tpu.ops.meshdata import MeshData, build_mesh_data
from fesom2_accelerate_tpu.parallel import partition as part_mod
from fesom2_accelerate_tpu.parallel.partition import PartitionedMesh


def _halo_fill(x, hmaps, B, H, axis_name="p"):
    """Rebuild the halo columns of ``x`` [.., >= 2H+B] from their owners'
    owned blocks.  One all-gather over the device axis; any padded columns
    beyond 2H+B pass through unchanged."""
    lo_part, lo_idx, hi_part, hi_idx = hmaps
    own = x[..., H:H + B]
    g = jax.lax.all_gather(own, axis_name)  # [P, .., B]
    g = jnp.moveaxis(g, 0, -2)  # [.., P, B]
    flat = g.reshape(g.shape[:-2] + (-1,))  # [.., P*B]
    lo = jnp.take(flat, lo_part * B + lo_idx, axis=-1)  # [.., H]
    hi = jnp.take(flat, hi_part * B + hi_idx, axis=-1)  # [.., H]
    tail = x[..., 2 * H + B:]
    return jnp.concatenate([lo, own, hi, tail], axis=-1)


def _halo_fill_nbr(x, smaps, B, H, n_parts, axis_name="p"):
    """Packed point-to-point halo fill: the MPI ``exchange_nod`` analogue
    (docs/refactoring.md:200), generalized to MULTI-HOP neighbor sets.

    Hop ``r`` packs, on every part at once, the owned columns its distance-r
    neighbors need (precomputed per-hop send lists) and moves one slab per
    direction via ``ppermute(shift r)``.  Received columns land in the halo
    via per-column (hop, position) maps.  Comm volume = sum of per-hop slab
    widths ~ true halo sizes — NOT P*B — for ANY stripe partition, including
    block size < mesh bandwidth where halos span several parts."""
    sends_up, sends_dn, lo_hop, lo_pos, hi_hop, hi_pos = smaps
    own = x[..., H:H + B]
    lo = jnp.zeros(x.shape[:-1] + (H,), x.dtype)
    hi = jnp.zeros(x.shape[:-1] + (H,), x.dtype)
    R = len(sends_up)
    for r in range(1, R + 1):
        up = jnp.take(own, sends_up[r - 1], axis=-1)  # for p+r's lo halo
        dn = jnp.take(own, sends_dn[r - 1], axis=-1)  # for p-r's hi halo
        fwd = [(p, p + r) for p in range(n_parts - r)]
        bwd = [(p, p - r) for p in range(r, n_parts)]
        rup = jax.lax.ppermute(up, axis_name, fwd)  # recv from p-r
        rdn = jax.lax.ppermute(dn, axis_name, bwd)  # recv from p+r
        lo = jnp.where(lo_hop == r,
                       jnp.take(rup, lo_pos, axis=-1, mode="clip"), lo)
        hi = jnp.where(hi_hop == r,
                       jnp.take(rdn, hi_pos, axis=-1, mode="clip"), hi)
    tail = x[..., 2 * H + B:]
    return jnp.concatenate([lo, own, hi, tail], axis=-1)


def sharded_fct_ale_step(md: MeshData, cfg: FctAleConfig, exchange,
                         state: dict) -> dict:
    """One XLA-path FCT-ALE step on this device's subdomain (runs inside
    shard_map).  ``exchange``: halo-fill callable (all-gather or ppermute)."""
    lim = single.pre_comm(md, cfg, state["ttf"], state["fct_LO"],
                          state["fct_adf_v"], state["fct_adf_h"])
    plus, minus = lim["fct_plus"], lim["fct_minus"]

    # start the halo exchange of both limiter-factor fields ...
    both = jnp.stack([plus, minus])
    both = exchange(both)

    # ... while b3_vertical (pure node-local, owned columns already final)
    # runs on the pre-exchange values — the reference's inter_comm overlap
    adf_v, adf_v2 = single.inter_comm(md, cfg, plus, minus,
                                      state["fct_adf_v"])

    plus, minus = both[0], both[1]
    adf_h, adf_h2 = single.post_comm(md, cfg, plus, minus,
                                     state["fct_adf_h"])

    out = dict(state)
    out.update(
        fct_ttf_max=lim["fct_ttf_max"], fct_ttf_min=lim["fct_ttf_min"],
        fct_plus=plus, fct_minus=minus,
    )
    if cfg.iter_yn:
        new_LO = stages.c_update_LO(
            md, state["fct_LO"], adf_v, adf_h, state["hnode_new"], cfg.dt
        )
        # halo refresh so the next iteration's a1 sees current fct_LO
        new_LO = exchange(new_LO)
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


# Edge fields live on per-part edge lists; every other state field is a
# node (or node-interface) field.
_EDGE_FIELDS = frozenset({"fct_adf_h", "fct_adf_h_limited"})


class ShardedFctAleSolver:
    """Domain-decomposed FCT-ALE over a 1-D device mesh axis ``p``.

    The global mesh is partitioned host-side (:func:`partition_mesh`); every
    per-part array is stacked to a ``[P, ...]`` leading axis and sharded over
    the devices, so each device holds exactly its subdomain.

    exchange: "auto" (ppermute when the partition is neighbor-only, else
    all-gather), "ppermute" (force; raises if not neighbor-only), or
    "allgather".

    tracers: Tb > 1 runs Tb tracers per shard through one compiled step
    (``jax.vmap`` of the local step); ``init_state`` then expects per-tracer
    [Tb, L, N]-family fields with shared [L, N] ``hnode``/``hnode_new``."""

    def __init__(self, mesh: Mesh, cfg: FctAleConfig = FctAleConfig(),
                 devices=None, axis_name: str = "p",
                 exchange: str = "auto",
                 part_counts: "np.ndarray | None" = None,
                 tracers: int = 1):
        self.mesh = mesh
        self.cfg = cfg
        self.axis_name = axis_name
        self.tracers = tracers
        devices = devices if devices is not None else jax.devices()
        self.n_parts = len(devices)
        self.jax_mesh = JaxMesh(np.asarray(devices), (axis_name,))
        # part_counts: realize a 2-D RCB partition (mesh.ordering.rcb_order
        # + reorder_mesh) through the contiguous-range machinery
        self.pm: PartitionedMesh = part_mod.partition_mesh(
            mesh, self.n_parts, counts=part_counts)
        pm = self.pm

        if exchange == "auto":
            exchange = "ppermute" if self.n_parts > 1 else "allgather"
        self.exchange_mode = exchange

        shard = NamedSharding(self.jax_mesh, P(axis_name))
        self._sharding = shard
        # single-process: plain device_put of a host array, which sends each
        # shard straight to its device.  Multi-process (multi-host): every
        # process holds the full host-side array (mesh setup is redundant per
        # process, like each MPI rank building its subdomain) and contributes
        # only its addressable shards.
        self._multiproc = any(
            d.process_index != jax.process_index() for d in devices
        )

        def put(x):
            x = np.asarray(x)
            if not self._multiproc:
                return jax.device_put(x, shard)
            return jax.make_array_from_callback(
                x.shape, shard, lambda idx: x[idx]
            )

        self._put = put

        if exchange == "ppermute":
            emaps = (tuple(pm.hop_send_up), tuple(pm.hop_send_dn),
                     pm.halo_lo_hop, pm.halo_lo_pos,
                     pm.halo_hi_hop, pm.halo_hi_pos)
        else:
            emaps = (pm.halo_lo_src_part, pm.halo_lo_src_idx,
                     pm.halo_hi_src_part, pm.halo_hi_src_idx)
        self._hmaps = jax.tree.map(put, emaps)
        B, H = pm.B, pm.H
        n_parts = self.n_parts

        def make_exchange(maps):
            if self.exchange_mode == "ppermute":
                return functools.partial(
                    _halo_fill_nbr, smaps=maps, B=B, H=H, n_parts=n_parts,
                    axis_name=axis_name,
                )
            return functools.partial(
                _halo_fill, hmaps=maps, B=B, H=H, axis_name=axis_name
            )

        mds = [build_mesh_data(m, dtype=cfg.dtype, xp=np)
               for m in pm.local_meshes]
        self.md = jax.tree.map(lambda *xs: put(np.stack(xs)), *mds)

        def local_step(md, hmaps, state):
            md = jax.tree.map(lambda x: x[0], md)
            hmaps = jax.tree.map(lambda x: x[0], hmaps)
            state = jax.tree.map(lambda x: x[0], state)
            step = functools.partial(sharded_fct_ale_step, md, cfg,
                                     make_exchange(hmaps))
            if tracers > 1:
                step = functools.partial(single.vmap_tracers, step)
            out = step(state)
            return jax.tree.map(lambda x: x[None], out)

        smapped = jax.shard_map(
            local_step,
            mesh=self.jax_mesh,
            in_specs=(P(axis_name), P(axis_name), P(axis_name)),
            out_specs=P(axis_name),
        )
        # mesh data / halo maps are jit ARGUMENTS (closure-captured device
        # arrays would be inlined as HLO constants)
        self._step = jax.jit(smapped)
        self._smapped = smapped

    # ---- state movement -------------------------------------------------
    def init_state(self, fields: dict) -> dict:
        """Global host fields -> per-part stacks, built in numpy and put
        straight to their shards."""
        pm = self.pm
        dtype = self.cfg.np_dtype
        out = {}
        for k, v in fields.items():
            v = np.asarray(v)
            if v.shape[-1] == self.mesh.n_nodes:
                loc = part_mod.scatter_node_field(pm, v)
            elif v.shape[-1] == self.mesh.n_edges:
                loc = part_mod.scatter_edge_field(pm, v)
            else:
                raise ValueError(f"unknown field layout for {k}: {v.shape}")
            out[k] = self._put(loc.astype(dtype, copy=False))
        return out

    def gather_node(self, arr) -> np.ndarray:
        if self._multiproc:
            # replicate the sharded result to every process (the host-side
            # analogue of FESOM's gather for diagnostics)
            from jax.experimental import multihost_utils

            arr = multihost_utils.process_allgather(arr, tiled=True)
        return part_mod.gather_node_field(self.pm, np.asarray(arr))

    # ---- checkpoint / resume --------------------------------------------
    # Checkpoints store GLOBAL natural-layout state (gather on save,
    # re-scatter on load), so they are portable across partition counts
    # and process topologies — the property the reference could
    # not have (its state lives in host-FESOM per-rank arrays).

    def gather_state(self, state: dict) -> dict:
        """Sharded state -> global natural-layout numpy dict."""
        if self._multiproc:
            from jax.experimental import multihost_utils

            state = {k: multihost_utils.process_allgather(v, tiled=True)
                     for k, v in state.items()}
        out = {}
        for k, v in state.items():
            v = np.asarray(v)
            if k in _EDGE_FIELDS:
                out[k] = part_mod.gather_edge_field(self.pm, v)
            else:
                out[k] = part_mod.gather_node_field(self.pm, v)
        return out

    def save_checkpoint(self, path, state: dict, step: int = 0,
                        use_orbax: "bool | None" = None) -> None:
        from fesom2_accelerate_tpu.runtime import checkpoint as ckpt

        # gather_state contains a COLLECTIVE (process_allgather) in
        # multi-process runs — every process must participate; only the
        # file write is gated to process 0
        gathered = self.gather_state(state)
        if not self._multiproc or jax.process_index() == 0:
            ckpt.save_checkpoint(path, gathered, self.mesh, self.cfg,
                                 step=step, use_orbax=use_orbax)

    def load_checkpoint(self, path):
        """Returns (sharded device state, step) — scatters the global
        checkpoint through init_state, so a run saved at P parts resumes
        at THIS solver's partition."""
        from fesom2_accelerate_tpu.runtime import checkpoint as ckpt

        st, step = ckpt.load_checkpoint(path, self.mesh, self.cfg)
        return self.init_state(st), step

    # ---- stepping -------------------------------------------------------
    def step(self, state: dict) -> dict:
        return self._step(self.md, self._hmaps, state)

    def run(self, state: dict, n_steps: int) -> dict:
        if not hasattr(self, "_scan_cache"):
            self._scan_cache = {}
        if n_steps not in self._scan_cache:
            smapped = self._smapped

            @jax.jit
            def scan_steps(md, hmaps, s):
                def body(c, _):
                    new = smapped(md, hmaps, c)
                    return {k: new[k] for k in c}, None

                s, _ = jax.lax.scan(body, s, None, length=n_steps)
                return s

            self._scan_cache[n_steps] = scan_steps
        return self._scan_cache[n_steps](self.md, self._hmaps, state)
