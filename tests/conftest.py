"""Test configuration.

Tests run on the CPU backend with 8 virtual devices (so multi-device
sharding is exercised without several GPUs) and with x64 enabled, because the
correctness gate is float64 — matching the reference's ``real_type = double``
(reference include/fesom2-accelerate.h:10).  Must run before jax is imported.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from fesom2_accelerate_tpu.mesh import generate_planar_mesh, random_fields


@pytest.fixture(scope="session")
def toy_mesh():
    m = generate_planar_mesh(preset="toy")
    m.validate()
    return m


@pytest.fixture(scope="session")
def tiny_mesh():
    m = generate_planar_mesh(preset="tiny")
    m.validate()
    return m


@pytest.fixture(scope="session")
def small_mesh():
    m = generate_planar_mesh(preset="small")
    m.validate()
    return m


def masked_allclose(a, b, mask=None, rtol=1e-12, atol=1e-12, msg=""):
    a = np.asarray(a)
    b = np.asarray(b)
    if mask is not None:
        a = np.where(mask, a, 0.0)
        b = np.where(mask, b, 0.0)
    if not np.allclose(a, b, rtol=rtol, atol=atol):
        bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
        idx = np.argwhere(bad)[:5]
        raise AssertionError(
            f"{msg} mismatch at {bad.sum()}/{bad.size} entries; "
            f"first idx {idx.tolist()}; "
            f"a={a[bad][:5].tolist()} b={b[bad][:5].tolist()}"
        )
