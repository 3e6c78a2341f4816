"""SHIMMER sketch backend dispatch.

Backends:
  native  — C++ libpgrtk (multi-threaded, exact); default
  python  — sketch_ref (exact arbiter, slow); fallback
  device  — JAX kernels (ops/sketch.py, ops/sketch1.py) for batch
            sketching, chosen by utils/dispatch.py or forced with
            PGRTK_SKETCH_BACKEND=device; exact (the kernels fall back to
            native/host for the edge cases they flag: palindromic
            k-mers, chunk-straddling non-ACGT runs).

All three are validated against each other and against the reference-
generated golden .mdb (tests/test_sketch_ref.py, tests/test_ops_*.py).
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

from . import sketch_ref
from .spec import ShmmrSpec

def _forced():
    """PGRTK_SKETCH_BACKEND: "native" | "python" | "device" | None."""
    return os.environ.get("PGRTK_SKETCH_BACKEND") or None


def _native():
    if _forced() == "python":
        return None
    try:
        from ..native import api as native_api

        return native_api if native_api.available() else None
    except Exception:
        if _forced() == "native":
            raise
        return None


def sequence_to_shmmrs(
    rid: int, seq: bytes, spec: ShmmrSpec, padding: bool = False
) -> List[Tuple[int, int]]:
    nat = _native()
    if nat is not None:
        return nat.sequence_to_shmmrs(rid, seq, spec, padding)
    return sketch_ref.sequence_to_shmmrs(rid, seq, spec, padding)


def _batch_device(seqs, spec):
    from ..ops import sketch as dsk
    from ..ops import sketch1 as dsk1

    rids = [rid for rid, _s in seqs]
    byte_seqs = [s for _rid, s in seqs]
    if spec.sketch:
        return [
            list(zip(int_x, int_y))
            for int_x, int_y in (
                (x.tolist(), y.tolist())
                for x, y in dsk.sketch_mode2(byte_seqs, rids, spec)
            )
        ]
    return dsk1.sketch_mode1(byte_seqs, rids, spec)


def batch_sequence_to_shmmrs(
    seqs: Sequence[Tuple[int, bytes]], spec: ShmmrSpec, padding: bool = False
) -> List[List[Tuple[int, int]]]:
    """Sketch many (rid, seq) pairs; batched on the device when one is live
    and the batch is large enough (utils/dispatch.py), else parallel
    across sequences natively (the reference parallelizes the same way:
    seq_db.rs:456-469).  PGRTK_SKETCH_BACKEND forces a backend."""
    if not padding and seqs:
        from ..utils import dispatch

        total = sum(len(s) for _rid, s in seqs)
        # mode-1 (windowed minimizer) stays on the host unless forced:
        # its consumers need the mer stream on the host, and on the
        # earlier accelerator the compacted-plane download lost to the
        # native path (not yet measured on the H100).  Mode-2 keeps the
        # size-threshold auto-dispatch.  PGRTK_SKETCH_BACKEND=device
        # forces mode-1 onto the accelerator.
        forced = _forced()
        auto_ok = spec.sketch or forced == "device"
        if auto_ok and dispatch.use_device(
            total, forced=forced, what="sketch"
        ):
            return _batch_device(list(seqs), spec)
    nat = _native()
    if nat is not None:
        return nat.batch_sequence_to_shmmrs(seqs, spec, padding)
    return [sketch_ref.sequence_to_shmmrs(rid, s, spec, padding) for rid, s in seqs]


def batch_sequence_to_shmmrs_arrays(
    seqs: Sequence[Tuple[int, bytes]], spec: ShmmrSpec, padding: bool = False
):
    """batch_sequence_to_shmmrs returning per-seq (x, y) uint64 numpy
    arrays instead of tuple lists — at batch scale the Python tuple
    materialization costs more than the sketch itself, and the index
    build consumes arrays directly (core/seqdb.py)."""
    import numpy as np

    if not padding and seqs:
        from ..utils import dispatch

        total = sum(len(s) for _rid, s in seqs)
        forced = _forced()
        auto_ok = spec.sketch or forced == "device"  # see note above
        if auto_ok and dispatch.use_device(
            total, forced=forced, what="sketch"
        ):
            byte_seqs = [s for _rid, s in seqs]
            rids = [rid for rid, _s in seqs]
            if spec.sketch:
                from ..ops import sketch as dsk

                return dsk.sketch_mode2(byte_seqs, rids, spec)
            from ..ops import sketch1 as dsk1

            return dsk1.sketch_mode1_arrays(byte_seqs, rids, spec)
    nat = _native()
    if nat is not None:
        return nat.batch_sequence_to_shmmrs_arrays(seqs, spec, padding)
    return [
        (
            np.asarray([m[0] for m in ms], dtype=np.uint64),
            np.asarray([m[1] for m in ms], dtype=np.uint64),
        )
        for ms in (
            sketch_ref.sequence_to_shmmrs(rid, s, spec, padding)
            for rid, s in seqs
        )
    ]


def sequence_to_shmmrs_arrays(
    rid: int, seq: bytes, spec: ShmmrSpec, padding: bool = False
):
    """sequence_to_shmmrs returning (x, y) uint64 numpy arrays (skips
    the Python tuple materialization)."""
    import numpy as np

    nat = _native()
    if nat is not None:
        return nat.sequence_to_shmmrs_arrays(rid, seq, spec, padding)
    ms = sketch_ref.sequence_to_shmmrs(rid, seq, spec, padding)
    return (
        np.asarray([m[0] for m in ms], dtype=np.uint64),
        np.asarray([m[1] for m in ms], dtype=np.uint64),
    )
