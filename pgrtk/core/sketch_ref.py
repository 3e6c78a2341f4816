"""Exact scalar reference implementation of SHIMMER sketching.

This is the arbiter implementation: a direct re-derivation of the semantics
of the reference sketcher (reference: pgr-db/src/shmmrutils.rs:417-669),
used to validate both the native C++ sketcher and the JAX device
kernels.  It is written for clarity and bit-exactness, not speed.

A "mer" is the pair (x, y) packed exactly as the reference's MM128
(shmmrutils.rs:226-269):

    x = hash << 8 | span(=k)
    y = rid << 32 | pos << 1 | strand

All arithmetic is 64-bit wrapping (Python ints masked to 64 bits).
"""
from __future__ import annotations

from typing import List, Tuple

from .spec import ShmmrSpec

M64 = (1 << 64) - 1

# byte -> 2-bit code; raw 0-3 pass through, ACGT/acgt map to 0/1/2/3,
# everything else -> 4 (reference: shmmrutils.rs:426-436)
BASE2BITS = [4] * 256
for _i in range(4):
    BASE2BITS[_i] = _i
for _b, _c in ((65, 0), (67, 1), (71, 2), (84, 3)):  # A C G T
    BASE2BITS[_b] = _c
    BASE2BITS[_b + 32] = _c  # lowercase


def u64hash(key: int) -> int:
    """Thomas Wang 64-bit integer hash (reference: shmmrutils.rs:271-280)."""
    key = ((~key & M64) + (key << 21)) & M64
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & M64
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & M64
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & M64
    return key


def _hash_mer(f0: int, f1: int, r0: int, r1: int) -> Tuple[int, int]:
    """Strand-canonical hash of the current k-mer registers.

    Returns (hash, strand).  Forward iff not (r0 < f0)
    (reference: shmmrutils.rs:485-496).
    """
    if r0 < f0:
        return u64hash(r0) ^ u64hash(r1 ^ 0xAD12CF59), 1
    return u64hash(f0) ^ u64hash(f1 ^ 0xAD12CF59), 0


def _mer_stream(rid: int, seq: bytes, k: int):
    """Yield (pos, x, y, h) for every non-palindromic k-mer position >= k.

    h is the full 64-bit strand-canonical hash (mode 2 thresholds on it,
    before the top 8 bits are lost in the x packing).  Implements the
    rolling forward/reverse-complement registers
    (reference: shmmrutils.rs:446-499).  Positions with non-ACGT bases do
    not advance the registers but still emit (stale register semantics).
    """
    shift = k - 1
    mask = M64 >> (64 - k)
    f0 = f1 = r0 = r1 = 0
    for pos, b in enumerate(seq):
        c = BASE2BITS[b]
        if c < 4:
            f0 = ((f0 << 1) | (c & 1)) & mask
            f1 = ((f1 << 1) | ((c & 2) >> 1)) & mask
            rc = 3 ^ c
            r0 = ((r0 >> 1) | ((rc & 1) << shift)) & mask
            r1 = ((r1 >> 1) | (((rc & 2) >> 1) << shift)) & mask
        if f0 == r0 and f1 == r1:
            continue  # palindromic k-mer: strand ambiguous, skipped
        if pos < k:
            continue
        h, strand = _hash_mer(f0, f1, r0, r1)
        x = ((h << 8) & M64) | k
        y = (rid << 32) | (pos << 1) | strand
        yield pos, x, y, h


class _Ring:
    """Fixed-size ring of mers (reference: shmmrutils.rs:293-357)."""

    __slots__ = ("v", "size", "start", "end", "len")

    def __init__(self, size: int):
        self.v = [(M64, M64)] * size
        self.size = size
        self.start = 0
        self.end = 0
        self.len = 0

    def push(self, m):
        self.v[self.end] = m
        self.end = (self.end + 1) % self.size
        if self.len < self.size:
            self.len += 1
        else:
            self.start = (self.start + 1) % self.size

    def min_x(self) -> int:
        # reference get_min scans raw storage order; only x matters
        return min(m[0] for m in self.v[: self.len]) if self.len else M64

    def get(self, i: int):
        return self.v[(self.start + i) % self.size]


def reduce_shmmr(mers, r: int, padding: bool = False):
    """Hierarchical reduction pass (reference: shmmrutils.rs:359-415)."""
    out = []
    if padding:
        pad = [(M64, M64)] * (r - 1)
        mers = pad + list(mers) + pad
    rbuf = _Ring(r)
    min_x = M64
    mdist = 0
    for pos, m in enumerate(mers):
        rbuf.push(m)
        if mdist == r - 1:
            min_x = rbuf.min_x()
            last_i = 0
            for i in range(rbuf.size):
                mm = rbuf.get(i)
                if mm[0] == min_x:
                    out.append(mm)
                    last_i = i
            mdist = r - 1 - last_i
        elif m[0] <= min_x and pos >= r:
            out.append(m)
            min_x = m[0]
            mdist = 0
        else:
            mdist += 1
    return out


def _min_span_filter(mers, min_span: int):
    """Distinctness / spacing filter (reference: shmmrutils.rs:536-555)."""
    n = len(mers)
    if n == 0:
        return []
    out = []
    for i, m in enumerate(mers):
        if i == 0 or i == n - 1:
            out.append(m)
            continue
        p_pos = (mers[i - 1][1] & 0xFFFFFFFF) >> 1
        pos = (m[1] & 0xFFFFFFFF) >> 1
        n_pos = (mers[i + 1][1] & 0xFFFFFFFF) >> 1
        if (
            pos - p_pos > min_span
            and n_pos - pos > min_span
            and mers[i - 1][0] != m[0]
            and m[0] != mers[i + 1][0]
        ):
            out.append(m)
    return out


def sequence_to_shmmrs1(
    rid: int, seq: bytes, w: int, k: int, r: int, min_span: int, padding: bool = False
):
    """Windowed-minimizer SHIMMER mode (reference: shmmrutils.rs:417-556)."""
    assert k <= 56 and w <= 128 and 0 < r < 13
    shmmrs: List[Tuple[int, int]] = []
    rbuf = _Ring(w)
    min_mer = (M64, M64)
    mdist = 0
    seqlen = len(seq)
    for pos, x, y, _h in _mer_stream(rid, seq, k):
        m = (x, y)
        rbuf.push(m)
        if mdist == w - 1:
            min_x = rbuf.min_x()
            for i in range(rbuf.size):
                mm = rbuf.get(i)
                if mm[0] == min_x:
                    shmmrs.append(mm)
                    min_mer = mm
            mdist = pos - ((min_mer[1] & 0xFFFFFFFF) >> 1)
        elif x <= min_mer[0] and w + k <= pos < seqlen - w + k:
            shmmrs.append(m)
            min_mer = m
            mdist = 0
        else:
            mdist += 1

    if r > 1:
        shmmrs = reduce_shmmr(reduce_shmmr(shmmrs, r, padding), r, padding)
    return _min_span_filter(shmmrs, min_span)


def sequence_to_shmmrs2(rid: int, seq: bytes, k: int, r: int, min_span: int):
    """Hash-threshold "sketch" mode (reference: shmmrutils.rs:558-655)."""
    assert k <= 56 and 0 < r < 13
    threshold = (M64 >> 4) >> r
    shmmrs = [
        (x, y)
        for _pos, x, y, h in _mer_stream(rid, seq, k)
        if h < threshold  # full 64-bit hash (reference: shmmrutils.rs:621)
    ]
    return _min_span_filter(shmmrs, min_span)


def sequence_to_shmmrs(rid: int, seq: bytes, spec: ShmmrSpec, padding: bool = False):
    """Dispatcher (reference: shmmrutils.rs:657-669)."""
    if spec.sketch:
        return sequence_to_shmmrs2(rid, seq, spec.k, spec.r, spec.min_span)
    return sequence_to_shmmrs1(
        rid, seq, spec.w, spec.k, spec.r, spec.min_span, padding
    )


def mer_hash(x: int) -> int:
    return x >> 8


def mer_pos(y: int) -> int:
    return (y & 0xFFFFFFFF) >> 1


def mer_strand(y: int) -> int:
    return y & 1
