"""What a measurement runs on: JAX's devices and the card's name and power limit.

Every speed number this repository reports names its device. A measurement that
finds no GPU stops; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import jax


def describe(devices=None) -> dict:
    """{"platform", "kind", "count"} of `devices` (default: jax.devices())."""
    devices = jax.devices() if devices is None else devices
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def require_gpu(devices=None) -> dict:
    """describe(devices), or SystemExit when the first device is not a GPU."""
    info = describe(devices)
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {info['platform']} ({info['kind']})"
        )
    return info


def card_line() -> str:
    """`name, power.limit` of each card, one line per card, as nvidia-smi
    reports them (a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
