"""Multi-process (multi-host) execution of the sharded step.

The reference's multi-node story lives in host FESOM2's MPI (SURVEY §4
"Multi-node: NOT tested in-repo"); here it is first-class: two OS processes
join via ``jax.distributed.initialize`` (gloo CPU collectives standing in
for the interconnect), the device mesh spans both processes (2 local
devices each -> 4 global), and the same shard_map + ppermute step runs
unchanged.  The
result must match the single-process solver on owned nodes."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_DIR = os.path.dirname(__file__)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmp_path, n_procs=2, timeout=420, n_steps=1,
                 iter_yn=False):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs, outs = [], []
    for pid in range(n_procs):
        out = os.path.join(str(tmp_path), f"w{pid}.npz")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(_DIR, "multiproc_worker.py"),
             coord, str(n_procs), str(pid), out,
             str(n_steps), str(int(iter_yn))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return outs


@pytest.mark.parametrize("n_steps,iter_yn", [
    (1, False),
    (1, True),
    # multi-step iterative mode: fct_LO carried through the halo refresh
    (3, True),
])
def test_two_process_matches_single(n_steps, iter_yn, tmp_path):
    outs = _run_workers(tmp_path, n_steps=n_steps, iter_yn=iter_yn)

    # single-process reference over the SAME global partition (4 parts)
    import jax
    import jax.numpy as jnp

    from fesom2_accelerate_tpu.config import FctAleConfig
    from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
    from fesom2_accelerate_tpu.parallel import ShardedFctAleSolver

    mesh = generate_planar_mesh(preset="tiny")
    cfg = FctAleConfig(dt=0.5, iter_yn=iter_yn, dtype=jnp.float32,
                       flux_eps=1e-7)
    solver = ShardedFctAleSolver(mesh, cfg, devices=jax.devices()[:4])
    fields = random_fields(mesh, seed=0, dtype=np.float32)
    state = solver.init_state(fields)
    state = (solver.step(state) if n_steps == 1
             else solver.run(state, n_steps))

    for out in outs:
        got = np.load(out)
        assert len(got.files) >= 2
        for k in got.files:
            ref = solver.gather_node(state[k])
            # same program on both sides; pin the f32 tolerance used by
            # the sharded tests so a collective-order change can't flake it
            np.testing.assert_allclose(got[k], ref, rtol=2e-6, atol=2e-6,
                                       err_msg=k)
