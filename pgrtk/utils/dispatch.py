"""Automatic host/device backend dispatch.

Batch workloads go to the accelerator by default — the reference
parallelizes with rayon thread pools and leaves "how many threads" to a
flag (pgr-bin: --number-of-thread); here the equivalent decision is
host-C++ vs device kernels, and it is made automatically:

  * device when a GPU backend is live AND the batch is large enough to
    amortize dispatch + padding (small batches are latency-bound and
    faster on the multi-threaded native path);
  * PGRTK_SKETCH_BACKEND=native|python|device still forces a backend;
  * PGRTK_DEVICE_MIN_BASES overrides the batch-size threshold.

Each decision is logged once per process on the `pgrtk` logger; a device
decision names the JAX platform and device kind, so a run shows where it
was served.
"""
from __future__ import annotations

import glob
import logging
import os

log = logging.getLogger("pgrtk")


def init_cli_logging(level=logging.INFO):
    """Attach a stderr handler to the pgrtk logger for CLI runs (so
    dispatch decisions and IO events are visible; PGRTK_LOG=debug|quiet
    overrides).  Library users configure logging themselves."""
    env = os.environ.get("PGRTK_LOG", "").lower()
    if env == "quiet":
        return
    if env == "debug":
        level = logging.DEBUG
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[%(asctime)s pgrtk] %(message)s", "%H:%M:%S")
        )
        log.addHandler(h)
    log.setLevel(level)

# Batch size (input bases) from which the device sketch + index pipeline
# is chosen over the native path.  Chosen on the earlier accelerator; not
# yet measured on the H100.
DEFAULT_MIN_BASES = 512 * 1024

_accel = None


def accelerator_present() -> bool:
    """True when JAX's default backend is an accelerator (not cpu).

    Lazy + cached: initializing a backend is expensive (it reserves most
    of the device's memory), so this is only evaluated the first time a
    batch-dispatch decision is needed.  Importing jax at all costs ~2.7 s
    of cold CLI latency, so environments that cannot have an accelerator
    (JAX_PLATFORMS=cpu, or no platform requested and no NVIDIA device
    nodes) are answered without the import.
    """
    global _accel
    if _accel is None:
        _accel = _detect_accelerator()
    return _accel


def _gpu_device_nodes() -> list:
    """NVIDIA device nodes on this machine (hardware evidence)."""
    return glob.glob("/dev/nvidiactl") + glob.glob("/dev/nvidia[0-9]*")


def _detect_accelerator() -> bool:
    import sys

    plats = os.environ.get("JAX_PLATFORMS", "").lower()
    requested = {p.strip() for p in plats.split(",") if p.strip()}
    if requested and requested <= {"cpu"}:
        return False
    nodes = _gpu_device_nodes()
    if not (nodes or requested or "jax" in sys.modules):
        return False
    import jax

    try:
        platform = jax.default_backend()
    except RuntimeError as e:
        log.error("JAX failed to start a backend (%s); batch work runs on "
                  "the host", e)
        return False
    if platform != "cpu":
        return True
    if nodes:
        log.error(
            "NVIDIA device nodes %s are present but JAX started the %r "
            "platform; batch work runs on the host",
            " ".join(nodes), platform,
        )
    return False


def _threshold() -> int:
    try:
        return int(os.environ.get("PGRTK_DEVICE_MIN_BASES", ""))
    except ValueError:
        return DEFAULT_MIN_BASES


def _device_name() -> str:
    import jax

    d = jax.devices()[0]
    return f"{d.platform} {d.device_kind}"


_logged = set()


def use_device(
    total_bases: int,
    *,
    forced: str | None = None,
    what: str = "",
    min_bases: int | None = None,
) -> bool:
    """Decide host vs device for a batch of `total_bases` input bases.
    `min_bases` overrides the default threshold for workloads whose
    per-base cost differs from sketching (e.g. WFA is ~100x heavier)."""
    if forced == "device":
        decision = True
    elif forced in ("native", "python", "host"):
        decision = False
    else:
        thr = _threshold() if min_bases is None else min_bases
        decision = total_bases >= thr and accelerator_present()
    key = (what, decision)
    if key not in _logged:
        _logged.add(key)
        log.info(
            "dispatch %s: %s backend (batch=%d bases%s)",
            what or "batch",
            f"device [{_device_name()}]" if decision else "host",
            total_bases,
            ", forced" if forced else "",
        )
    return decision
