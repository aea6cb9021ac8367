"""Worker for tests/test_multiprocess.py: one of N OS processes running the
sharded FCT-ALE step over a process-spanning device mesh (gloo CPU
collectives standing in for the interconnect).

Usage: python multiproc_worker.py <coordinator> <num_procs> <proc_id>
       <outfile> [<n_steps> <iter_yn>]

Writes gathered (global) owned-node results to <outfile> (.npz) so the
parent can compare against the single-process run.
"""

import os
import sys


def main():
    coordinator, n_procs, pid, outfile = sys.argv[1:5]
    n_steps = int(sys.argv[5]) if len(sys.argv) > 5 else 1
    iter_yn = bool(int(sys.argv[6])) if len(sys.argv) > 6 else False
    n_procs, pid = int(n_procs), int(pid)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from fesom2_accelerate_tpu.parallel import distributed as dist

    dist.init_distributed(coordinator_address=coordinator,
                          num_processes=n_procs, process_id=pid)
    assert jax.process_count() == n_procs
    devices = dist.global_devices()
    assert len(devices) == 2 * n_procs

    import numpy as np
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
    from fesom2_accelerate_tpu.parallel import ShardedFctAleSolver

    mesh = generate_planar_mesh(preset="tiny")
    cfg = FctAleConfig(dt=0.5, iter_yn=iter_yn, dtype=jnp.float32,
                       flux_eps=1e-7)
    solver = ShardedFctAleSolver(mesh, cfg, devices=devices)
    assert solver._multiproc
    fields = random_fields(mesh, seed=0, dtype=np.float32)
    state = solver.init_state(fields)
    if n_steps == 1:
        state = solver.step(state)
    else:
        state = solver.run(state, n_steps)
    jax.block_until_ready(state)

    out = {}
    keys = ["fct_plus", "fct_minus", "fct_adf_v"]
    keys += ["fct_LO"] if iter_yn else ["del_ttf_advvert", "del_ttf_advhoriz"]
    for k in keys:
        if k in state:
            out[k] = solver.gather_node(state[k])

    # sharded checkpoint across a REAL process boundary: gather_state's
    # process_allgather is a collective every process must enter (the
    # round-5 review caught a process-0-only gating that deadlocked here);
    # only process 0 writes the file
    ckdir = outfile + ".ck"
    solver.save_checkpoint(ckdir, state, step=n_steps, use_orbax=False)
    if jax.process_index() == 0:
        assert os.path.exists(os.path.join(ckdir, "meta.json")), (
            "process 0 must have written the checkpoint")

    np.savez(outfile, **out)
    print(f"proc {pid}: OK", flush=True)


if __name__ == "__main__":
    main()
