"""What the program runs on: the JAX device and the card behind it."""

from __future__ import annotations

import subprocess


def device_summary() -> dict:
    """Platform, kind and count of JAX's devices, as results name them."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line
    (a card below its top power limit runs slower under load, so every
    timing is reported beside it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip()
