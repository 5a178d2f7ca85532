"""What the run is on: the JAX device and, on an NVIDIA card, its name and
power limit (a card set below its maximum power runs slower under load, so
every timing is reported beside them)."""

from __future__ import annotations

import subprocess


def nvidia_smi_card() -> str:
    """``name, power.limit`` of the first card as nvidia-smi prints them,
    or ``"nvidia-smi unavailable"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi unavailable"


def describe() -> dict:
    """platform / kind / count of the default JAX backend's devices."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}
