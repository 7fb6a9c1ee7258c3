"""The accelerator the program measures on, and the card's own report."""

from __future__ import annotations

import subprocess


def require_gpu():
    """JAX's default device, which must be a GPU. Raises RuntimeError
    otherwise: a measurement never falls back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {dev.platform!r} "
            f"({dev.device_kind}); this measurement runs only on the card"
        )
    return dev


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (`name, power.limit`; one entry per card, joined by "; "), from a child
    process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(line.strip() for line in out.stdout.strip().splitlines())
