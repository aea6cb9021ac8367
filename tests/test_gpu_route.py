"""The measurement plumbing of the GPU route, checked on the CPU.

The peak-bandwidth table, the compile-cache helper, the device guards of the
entry-point scripts (they refuse to run without a GPU, and never fall back
to the CPU), and ``chip_smoke.py``'s phases rehearsed at tiny sizes.  The
smoke test itself runs on the card (``-m gpu``)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import __graft_entry__
import chip_smoke
from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu.runtime import compile_cache
from fesom2_accelerate_tpu.runtime.device import (
    NoGpuError,
    device_info,
    require_gpu,
)
from fesom2_accelerate_tpu.runtime.profiling import (
    HBM_PEAK_BYTES_PER_S,
    hbm_peak_bytes_per_s,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- peak table ---------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(HBM_PEAK_BYTES_PER_S))
def test_peak_table_known_kinds(kind):
    assert hbm_peak_bytes_per_s(kind) == HBM_PEAK_BYTES_PER_S[kind] > 1e12


def test_peak_table_h100_sxm_datasheet():
    assert hbm_peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "Accelerator v1",
                                  "NVIDIA A100-SXM4-80GB", "",
                                  "nvidia h100 80gb hbm3"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        hbm_peak_bytes_per_s(kind)


# ---- compile cache ------------------------------------------------------


def test_compile_cache_honours_env():
    env = {compile_cache.ENV: "/some/where"}
    assert compile_cache.compile_cache_dir(env) == "/some/where"


def test_compile_cache_default_inside_checkout():
    path = compile_cache.compile_cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")
    # the fixed default is ignored by git
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_sets_default_only_without_env(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        default = compile_cache.DEFAULT_DIR
        assert compile_cache.enable_compile_cache() == default
        assert jax.config.jax_compilation_cache_dir == default
        jax.config.update("jax_compilation_cache_dir", old)
        monkeypatch.setenv(compile_cache.ENV, "/from/env")
        assert compile_cache.enable_compile_cache() == "/from/env"
        # JAX reads the variable itself: the config is left alone
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


# ---- device guards ------------------------------------------------------


def test_require_gpu_refuses_cpu():
    with pytest.raises(NoGpuError, match="no GPU found"):
        require_gpu()


def test_device_info_names_the_device():
    info = device_info()
    assert info["platform"] == "cpu" and info["count"] == len(jax.devices())


def _run(args, cwd=REPO, pythonpath=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=pythonpath)
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "bench_scaling.py"])
def test_scripts_refuse_cpu(script):
    p = _run([os.path.join(REPO, script)])
    assert p.returncode != 0
    assert "no GPU found" in p.stderr
    assert '"ok"' not in p.stdout and '"metric"' not in p.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the package, the script fails and
    prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
             pythonpath=str(tmp_path))
    assert p.returncode != 0
    assert "fesom2_accelerate_tpu" in p.stderr
    assert '"ok"' not in p.stdout


# ---- chip_smoke phases, rehearsed at tiny sizes on the CPU ---------------


@pytest.fixture(scope="module")
def small():
    mesh = generate_planar_mesh(preset="small")
    return mesh, random_fields(mesh, seed=0)


@pytest.fixture(scope="module")
def tiny():
    mesh = generate_planar_mesh(preset="tiny")
    return mesh, random_fields(mesh, seed=1)


def test_smoke_f64_and_f32_phases(small):
    setup_s = {}
    ref = chip_smoke.phase_f64_oracle(*small, setup_s)
    chip_smoke.phase_f32(*small, ref, setup_s)
    assert set(setup_s) >= {"step f64 iter=False", "step f32 iter=False"}


def test_smoke_vlimit_phase(tiny):
    chip_smoke.phase_vlimit(*tiny)


def test_smoke_tracers_phase(small):
    chip_smoke.phase_tracers(small[0], {}, Tb=3, n=2)


def test_smoke_stress2rhs_phase(small):
    chip_smoke.phase_stress2rhs(small[0], {})


def test_smoke_host_abi_phase(tiny):
    chip_smoke.phase_host_abi(*tiny)


def test_smoke_multi_phase_on_4_virtual_devices(small):
    chip_smoke.phase_multi(*small, jax.devices()[:4], n=2)


def test_smoke_check_fails_loudly():
    with pytest.raises(AssertionError):
        chip_smoke.check_close("x", np.ones(3), np.ones(3) + 1e-9)
    with pytest.raises(AssertionError):
        chip_smoke.check_scaled("x", np.ones(3), np.ones(3) * 1.01, 1e-3)


def test_dryrun_multichip_on_virtual_devices():
    __graft_entry__.dryrun_multichip(4)


# ---- on the card ---------------------------------------------------------


@pytest.fixture
def gpu():
    """Skip unless a GPU is present, decided here (never at import): the
    test session itself is held to the CPU, so ask a child process."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine (nvidia-smi not found)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if p.stdout.strip() != "gpu":
        pytest.skip("JAX finds no GPU on this machine")
    return env


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu):
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=gpu, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
