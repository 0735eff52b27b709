"""The device a measurement runs on. Every benchmark entry point refuses
to run anywhere but an NVIDIA GPU, and every result it prints names the
device as JAX reports it."""

from __future__ import annotations

import subprocess

import jax


def device_info() -> dict:
    """{platform, device_kind, count} of the default backend's devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(min_count: int = 1) -> dict:
    """device_info() if JAX sees at least `min_count` GPUs; otherwise exit
    nonzero with a message naming what was found instead."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {info['count']} {info['platform']} device(s) "
            f"({info['device_kind']}); this measurement runs only on an NVIDIA GPU")
    if info["count"] < min_count:
        raise SystemExit(f"need {min_count} GPUs, JAX found {info['count']}")
    return info


def card_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, joined
    by '; ' (a card set below its maximum power runs slower under load,
    so every number is reported beside this)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in res.stdout.splitlines() if line.strip())
