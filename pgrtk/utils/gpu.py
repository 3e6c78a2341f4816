"""What a measured run states about its device: the JAX platform, the
card's name and power limit, and peak device memory."""
from __future__ import annotations

import subprocess
import sys


def require_gpu(prog: str):
    """Return jax.devices(), or exit non-zero when JAX's first device is
    not a GPU: a measurement must not fall back to the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(
            f"{prog}: no GPU (JAX platform {devs[0].platform!r}); "
            "refusing to run on the CPU"
        )
    return devs


def card_info() -> list:
    """[(name, power_limit)] per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [
        tuple(f.strip() for f in line.split(",", 1))
        for line in out.splitlines() if line.strip()
    ]


def peak_bytes_in_use(device) -> int | None:
    """Peak device memory the process's arrays have taken so far (None
    where the backend keeps no statistics, e.g. the CPU)."""
    stats = device.memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))
