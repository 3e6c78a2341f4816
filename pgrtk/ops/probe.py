"""Bucketed dense probe table: the device replacement for hash-map /
binary-search key lookup.

The reference keys its fragment index with a Rust FxHashMap
(pgr-db/src/seq_db.rs:72-78); a vectorized 128-bit binary search (see
parallel/mesh.py) is correct but gather-bound (~23 dependent rounds of
random device-memory access per query).  Because shimmer-pair keys are
uniform Wang hashes, a flat bucket table beats both: partition the
key-sorted table by the top `bits` of hash0, pad every bucket to a fixed
width W (a multiple of 128 slots), and probe with ONE aligned
row fetch + W-wide vector compare per query — no dependent memory
chain, no scalar gathers.

Memory is N * slack (slack ~2x with W=128, lambda=64); the build fails
over to a wider W if any bucket overflows (uniform hashes make that
geometrically improbable).
"""
from __future__ import annotations

import numpy as np

HASH_BITS = 56  # shimmer hashes are 56-bit (x >> 8)


def build_probe_table(keys: np.ndarray, avg_per_bucket: int = 64):
    """Bucket a KEY-SORTED (N, 2) uint64 key array into dense planes.

    Returns dict with:
      bits        : bucket index width (top bits of hash0)
      planes      : 4 x (2^bits, W) uint32 (k0_hi, k0_lo, k1_hi, k1_lo),
                    padded with 0xFFFFFFFF (never a real 56-bit hash)
      row         : (2^bits, W) int32 — row index into the sorted table
                    for each slot (-1 for padding), so a probe hit maps
                    back to the table's postings block
    """
    n = len(keys)
    bits = max(1, int(np.ceil(np.log2(max(2, n / avg_per_bucket)))))
    shift = np.uint64(HASH_BITS - bits)
    bucket = (keys[:, 0] >> shift).astype(np.int64)
    counts = np.bincount(bucket, minlength=1 << bits)
    W = 128
    while counts.max() > W:
        W *= 2
    nb = 1 << bits
    planes = np.full((4, nb, W), 0xFFFFFFFF, dtype=np.uint32)
    row = np.full((nb, W), -1, dtype=np.int32)
    # table is key-sorted => buckets are contiguous runs
    offsets = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    cols = np.arange(n, dtype=np.int64) - offsets[bucket]
    planes[0, bucket, cols] = (keys[:, 0] >> np.uint64(32)).astype(np.uint32)
    planes[1, bucket, cols] = (keys[:, 0] & np.uint64(0xFFFFFFFF)).astype(
        np.uint32
    )
    planes[2, bucket, cols] = (keys[:, 1] >> np.uint64(32)).astype(np.uint32)
    planes[3, bucket, cols] = (keys[:, 1] & np.uint64(0xFFFFFFFF)).astype(
        np.uint32
    )
    row[bucket, cols] = np.arange(n, dtype=np.int32)
    return dict(bits=bits, planes=planes, row=row)


def _probe_hits(table, q_h0, q_l0, q_h1, q_l1):
    import jax.numpy as jnp

    bits = table["bits"]
    t0, t1, t2, t3 = (table["planes"][i] for i in range(4))
    bucket = (q_h0 >> (24 - bits)) if bits <= 24 else (
        (q_h0 << (bits - 24)) | (q_l0 >> (56 - bits))
    )
    bucket = bucket.astype(jnp.int32)
    # ONE aligned row fetch per query (W-wide tiles), then vector compare
    hit = (
        (jnp.take(t0, bucket, axis=0) == q_h0[:, None])
        & (jnp.take(t1, bucket, axis=0) == q_l0[:, None])
        & (jnp.take(t2, bucket, axis=0) == q_h1[:, None])
        & (jnp.take(t3, bucket, axis=0) == q_l1[:, None])
    )
    return hit, bucket


def probe_found(table, q_h0, q_l0, q_h1, q_l1):
    """Membership-only probe: (Q,) bool."""
    hit, _ = _probe_hits(table, q_h0, q_l0, q_h1, q_l1)
    return hit.any(axis=1)


def probe_keys(table, q_h0, q_l0, q_h1, q_l1):
    """Vectorized probe: (found, row) per query key.

    table: dict from build_probe_table with planes as device arrays
    (t["planes"][i] -> (2^bits, W) jnp.uint32, t["row"] -> int32).
    q_*: (Q,) uint32 planes of the query keys.
    Returns found (Q,) bool and row (Q,) int32 (-1 if absent) — row
    indexes the key-sorted table for postings expansion.
    """
    import jax.numpy as jnp

    hit, bucket = _probe_hits(table, q_h0, q_l0, q_h1, q_l1)
    br = jnp.take(table["row"], bucket, axis=0)
    found = hit.any(axis=1)
    # first (lowest-row) hit; padding rows are -1 so mask with max
    big = jnp.int32(2**31 - 1)
    row = jnp.where(hit, br, big).min(axis=1)
    return found, jnp.where(found, row, -1)


def build_probe_table_dense(keys: np.ndarray, avg_per_bucket: int = 32):
    """Two-level fence+probe layout: ~1.0x key-array memory (vs ~2.5x
    for the padded-bucket planes incl. their row plane).

    Keys are stored DENSE in key-sorted order as 4 u32 planes reshaped
    to 128-wide rows; a fence array gives each bucket's start offset.
    A probe gathers the bucket's fence, fetches the TWO aligned 128-wide
    rows covering [start, start+256), and compares.  The matched
    position IS the table row (no row plane at all).

    avg_per_bucket defaults to 32 because canonical pair keys are
    min(h0, h1): the minimum of two uniforms has density 2x at the low
    end, so the lowest buckets hold ~2*lambda keys — lambda=32 keeps the
    worst bucket ~64+noise, comfortably under the 128-slot fetch window
    (lambda=64 overflowed on a real min-canonicalized key set).

    Returns dict(bits, planes 4 x (ceil(N/128)+1, 128) u32, fence
    (2^bits + 1,) i32, n).  Raises ValueError if any bucket exceeds the
    128-slot fetch window — callers fall back to build_probe_table.
    """
    n = len(keys)
    bits = max(1, int(np.ceil(np.log2(max(2, n / avg_per_bucket)))))
    shift = np.uint64(HASH_BITS - bits)
    bucket = (keys[:, 0] >> shift).astype(np.int64)
    counts = np.bincount(bucket, minlength=1 << bits)
    if counts.max() > 128:
        # raise (not assert: python -O must not strip it) — callers fall
        # back to build_probe_table, which widens W until buckets fit
        raise ValueError(
            f"dense probe bucket overflow (max {int(counts.max())} > 128);"
            " use build_probe_table"
        )
    nb = 1 << bits
    fence = np.zeros(nb + 1, dtype=np.int32)
    np.cumsum(counts, out=fence[1:])
    n_rows = -(-n // 128) + 1  # +1: the second fetched row may run off
    planes = np.full((4, n_rows, 128), 0xFFFFFFFF, dtype=np.uint32)
    flat = planes.reshape(4, -1)
    flat[0, :n] = (keys[:, 0] >> np.uint64(32)).astype(np.uint32)
    flat[1, :n] = (keys[:, 0] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    flat[2, :n] = (keys[:, 1] >> np.uint64(32)).astype(np.uint32)
    flat[3, :n] = (keys[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return dict(
        bits=bits, planes=planes, fence=fence,
        fence_rows=fence_to_rows(fence), n=n,
    )


def build_probe_table_aligned(keys: np.ndarray, avg_per_bucket: int = 32):
    """Dense fence layout with buckets PADDED to never cross a 128-slot
    row boundary, so a probe fetches ONE aligned row per key plane
    instead of two (5 gathered rows/key incl. the row fence vs 9 for
    the dense layout; gather cost grows with the rows fetched).

    Memory: ~(1 + lambda/256)x keys (expected ~half a bucket of padding
    per 128-row; measured ~1.13x at lambda=32 on uniform keys).  The
    matched PADDED position is the table row, so postings planes built
    against this layout must scatter rows by `pos`.

    Returns dict(bits, planes 4 x (n_rows, 128) u32, fence
    (2^bits + 1,) i32 (PADDED offsets), fence_rows, pos (n,) i64 padded
    position per key-sorted index, n, n_padded, aligned=True).  Raises
    ValueError if any bucket exceeds 128 slots (same fallback contract
    as build_probe_table_dense).
    """
    n = len(keys)
    bits = max(1, int(np.ceil(np.log2(max(2, n / avg_per_bucket)))))
    shift = np.uint64(HASH_BITS - bits)
    bucket = (keys[:, 0] >> shift).astype(np.int64)
    counts = np.bincount(bucket, minlength=1 << bits).astype(np.int64)
    if counts.max() > 128:
        raise ValueError(
            f"aligned probe bucket overflow (max {int(counts.max())} >"
            " 128); use build_probe_table"
        )
    nb = 1 << bits
    # padded bucket starts: advance to the next row boundary whenever a
    # bucket would straddle one.  Sequential recurrence — the native
    # scan (native/src/probe_align.cc) runs it at memory speed (the
    # Python loop costs ~8 s at 32M keys / 1M buckets); fallback stays
    # for environments without the native library
    native_starts = None
    try:
        from ..native import api as native_api

        native_starts = native_api.probe_align_starts(counts)
    except Exception:  # pragma: no cover - native build unavailable
        native_starts = None
    if native_starts is not None:
        starts, n_padded = native_starts
    else:  # pragma: no cover - exercised only without libpgrtk.so
        starts = np.zeros(nb, dtype=np.int64)
        off = 0
        for b in range(nb):
            if (off & 127) + counts[b] > 128:
                off = (off + 127) & ~127
            starts[b] = off
            off += counts[b]
        n_padded = int(off)
    fence = np.zeros(nb + 1, dtype=np.int32)
    fence[:nb] = starts
    fence[nb] = n_padded
    pos = starts[bucket] + (
        np.arange(n, dtype=np.int64)
        - np.concatenate(([0], np.cumsum(counts)))[bucket]
    )
    n_rows = -(-max(n_padded, 1) // 128)
    planes = np.full((4, n_rows, 128), 0xFFFFFFFF, dtype=np.uint32)
    flat = planes.reshape(4, -1)
    flat[0, pos] = (keys[:, 0] >> np.uint64(32)).astype(np.uint32)
    flat[1, pos] = (keys[:, 0] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    flat[2, pos] = (keys[:, 1] >> np.uint64(32)).astype(np.uint32)
    flat[3, pos] = (keys[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return dict(
        bits=bits, planes=planes, fence=fence,
        fence_rows=fence_to_rows(fence), pos=pos, n=n,
        n_padded=n_padded, aligned=True,
    )


def probe_keys_aligned(table, q_h0, q_l0, q_h1, q_l1):
    """Vectorized probe of an ALIGNED fence table: ONE row fetch per
    plane (buckets never straddle rows).  Returns (found, row) with row
    = matched PADDED position (-1 if absent)."""
    import jax.numpy as jnp

    bits = table["bits"]
    t0, t1, t2, t3 = (table["planes"][i] for i in range(4))
    fence = table["fence"]
    bucket = (q_h0 >> (24 - bits)) if bits <= 24 else (
        (q_h0 << (bits - 24)) | (q_l0 >> (56 - bits))
    )
    if fence.ndim == 2:
        b32 = bucket.astype(jnp.int32)
        frow = jnp.take(fence, b32 >> 7, axis=0)
        lane = b32 & jnp.int32(127)
        iota = jnp.arange(128, dtype=jnp.int32)
        start = jnp.where(
            iota[None, :] == lane[:, None], frow, jnp.int32(0)
        ).sum(axis=1)
    else:
        start = jnp.take(fence, bucket.astype(jnp.int32))
    base = start >> 7
    hit = (
        (jnp.take(t0, base, axis=0) == q_h0[:, None])
        & (jnp.take(t1, base, axis=0) == q_l0[:, None])
        & (jnp.take(t2, base, axis=0) == q_h1[:, None])
        & (jnp.take(t3, base, axis=0) == q_l1[:, None])
    )  # (Q, 128)
    found = hit.any(axis=1)
    pos = jnp.argmax(hit, axis=1).astype(jnp.int32)
    row = (base << 7) + pos
    return found, jnp.where(found, row, -1)


def fence_to_rows(fence: np.ndarray) -> np.ndarray:
    """Reshape a (2^bits + 1,) fence into zero-padded 128-wide rows.

    The fence is fetched as one 128-wide row and the wanted lane is
    selected arithmetically, instead of a per-key scalar gather; the
    four KEY planes stay separate row gathers (interleaving them into
    one (rows, 4, 128) array lowered to a slower gather on the earlier
    accelerator).  Neither choice is yet measured on the H100
    (scripts/bench_probe.py times the variants).
    """
    nfr = -(-len(fence) // 128)
    fr = np.zeros((nfr * 128,), fence.dtype)
    fr[: len(fence)] = fence
    return fr.reshape(nfr, 128)


def probe_keys_dense(table, q_h0, q_l0, q_h1, q_l1):
    """Vectorized probe of a dense fence table: (found, row) per query
    key, row = index into the key-sorted table (-1 if absent).

    table["fence"] may be the flat (2^bits + 1,) array or the
    fence_to_rows 128-wide layout — the 2-D layout replaces the scalar
    fence gather with a row fetch + arithmetic lane select (measured
    1.28x at bench shapes, see fence_to_rows)."""
    import jax.numpy as jnp

    bits = table["bits"]
    t0, t1, t2, t3 = (table["planes"][i] for i in range(4))
    fence = table["fence"]
    bucket = (q_h0 >> (24 - bits)) if bits <= 24 else (
        (q_h0 << (bits - 24)) | (q_l0 >> (56 - bits))
    )
    if fence.ndim == 2:
        b32 = bucket.astype(jnp.int32)
        frow = jnp.take(fence, b32 >> 7, axis=0)  # (Q, 128)
        lane = b32 & jnp.int32(127)
        iota = jnp.arange(128, dtype=jnp.int32)
        start = jnp.where(
            iota[None, :] == lane[:, None], frow, jnp.int32(0)
        ).sum(axis=1)
    else:
        start = jnp.take(fence, bucket.astype(jnp.int32))
    base = start >> 7  # 128-wide rows
    rows2 = jnp.stack([base, base + 1], axis=1)  # (Q, 2)
    hit = (
        (jnp.take(t0, rows2, axis=0) == q_h0[:, None, None])
        & (jnp.take(t1, rows2, axis=0) == q_l0[:, None, None])
        & (jnp.take(t2, rows2, axis=0) == q_h1[:, None, None])
        & (jnp.take(t3, rows2, axis=0) == q_l1[:, None, None])
    )  # (Q, 2, 128)
    found = hit.any(axis=(1, 2))
    pos = jnp.argmax(hit.reshape(hit.shape[0], -1), axis=1).astype(jnp.int32)
    row = (base << 7) + pos
    return found, jnp.where(found, row, -1)
