"""The device a measurement ran on, for every result that prints a number."""

from __future__ import annotations

import subprocess


def gpu_record() -> dict:
    """Platform, device kind and count as JAX reports them, and the card's
    name and power limit as ``nvidia-smi`` reports them.

    Raises SystemExit where JAX's first device is not a GPU: a measurement
    never falls back to the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {devs[0].platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].strip()
    return {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs), "card": card,
    }
