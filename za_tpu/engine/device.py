"""The device a measurement runs on: its refusal of a CPU fallback and
the lines that name the card beside every number."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> None:
    """Exit non-zero unless JAX runs on a GPU: a measurement never
    falls back to the CPU."""
    platform = jax.default_backend()
    if platform != "gpu":
        raise SystemExit(
            f"error: needs an NVIDIA GPU, JAX found platform {platform!r}"
        )


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.replace("\n", " | ")


def device_json() -> dict:
    """The device as JAX reports it (platform, kind, count)."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
