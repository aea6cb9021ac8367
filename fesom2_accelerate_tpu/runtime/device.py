"""The device a measurement runs on.

Every result a measurement path prints names its device, and a path that
finds no GPU stops: it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess


class NoGpuError(RuntimeError):
    """JAX found no GPU."""


def require_gpu():
    """The first JAX device, which must be a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGpuError(
            f"no GPU found: JAX's default device is {dev.platform!r} "
            f"({dev.device_kind}); this measurement runs only on a GPU")
    return dev


def device_info() -> dict:
    """platform, device_kind and device count, as JAX reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s card name and power limit (one line per card), read
    by a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
