"""What a measurement reports about the device it ran on."""

from __future__ import annotations

import subprocess

import jax


def device_record() -> dict:
    """``platform``, ``kind`` and ``count`` of the default backend, as JAX
    reports them."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def card_name_and_power_limit() -> str:
    """The first card's ``name, power.limit`` line from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]
