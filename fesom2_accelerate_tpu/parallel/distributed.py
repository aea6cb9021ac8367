"""Multi-process (multi-host) launch support.

The reference binds one GPU per MPI rank (``set_mpi_rank_``, reference
src/fesom2-accelerate.cu:206-228) and leaves the halo exchange to the host's
MPI.  Here ``jax.distributed.initialize`` joins the processes into one
runtime, every process sees the GLOBAL device list, and the same
``shard_map`` + ``ppermute`` step (step_sharded.py) runs unchanged.

Device ordering is the one thing that matters for halo-exchange locality:
the stripe partition assigns part ``p`` to ``devices[p]``, so devices must
be ordered with each process's devices CONTIGUOUS — then all but one
neighbor hop per process boundary stay inside a host, and exactly one hop
per process pair crosses between hosts (the minimum possible for a 1-D
decomposition).

Launch (per process)::

    from fesom2_accelerate_tpu.parallel import distributed as dist
    dist.init_distributed(coordinator_address="host0:1234",
                          num_processes=4, process_id=rank)
    solver = ShardedFctAleSolver(mesh, cfg, devices=dist.global_devices())
    state = solver.init_state(fields)      # per-process shards only
    state = solver.step(state)

On GPUs nothing detects a cluster by itself: pass the coordinator address
(any free ``host:port`` on process 0's host), the process count and this
process's id explicitly, as above.  One process can also drive every card
of a host, which is how the 4-card path of ``chip_smoke.py --multi`` runs;
several processes over GPUs are untested here.  For CPU-based testing, gloo
collectives back the same path (tests/test_multiprocess.py runs two OS
processes over a 4-device global mesh).
"""

from __future__ import annotations

import jax


def init_distributed(coordinator_address: "str | None" = None,
                     num_processes: "int | None" = None,
                     process_id: "int | None" = None,
                     local_device_ids=None) -> None:
    """Join this process into a multi-process JAX runtime (the analogue of
    the reference's ``set_mpi_rank_``, src/fesom2-accelerate.cu:206-228).

    Arguments left as None are left to ``jax.distributed.initialize``,
    which detects them only on clusters it knows; on GPUs pass all three."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def global_devices(backend: "str | None" = None) -> list:
    """Global device list ordered process-contiguously.

    ``devices[p]`` hosts stripe part ``p``; process-contiguous order keeps
    every intra-process neighbor hop inside a host and exactly one
    cross-host hop per adjacent process pair."""
    devs = jax.devices(backend) if backend else jax.devices()
    return sorted(devs, key=lambda d: (d.process_index, d.id))


def is_multiprocess() -> bool:
    return jax.process_count() > 1
