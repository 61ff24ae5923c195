"""Accelerator identity for measurements: every timing names its card."""
from __future__ import annotations

import subprocess


def require_gpu():
    """Return `jax.devices()`; raise unless JAX's first device is a GPU.

    Measurements and the chip smoke run only on the card: a CPU fallback
    would print CPU numbers under a device's name."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"needs a GPU; JAX found {devices[0].platform!r} "
            f"({devices[0].device_kind})")
    return devices


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]


def describe() -> dict:
    """Device label for results: JAX's view plus the card line."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card_line()}
