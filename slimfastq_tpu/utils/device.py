"""The accelerator a measurement ran on, for scripts that must name it.

Timing and smoke scripts call ``require_gpu`` first: a measurement path
that finds no GPU fails instead of falling back to the CPU.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """The first JAX device; raises RuntimeError unless it is a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {dev.platform!r}")
    return dev


def describe() -> dict:
    """Platform, device kind and device count as JAX reports them."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card() -> str:
    """Card name and power limit, as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return r.stdout.strip() or f"nvidia-smi failed ({r.stderr.strip()})"
