"""Batched SHIMMER sketching on device (JAX/XLA).

Design (vs the reference's sequential scalar walk,
pgr-db/src/shmmrutils.rs:417-669):

  * Sequences arrive as a padded (B, L) uint8 batch and are cut into
    fixed-size chunks.  The rolling k-mer register recurrence
    ("shift in one 2-bit base unless ambiguous") is evaluated with a
    **two-level Blelloch-style scan**:
      1. a `lax.scan` marches down the chunk axis with every chunk in a
         separate lane (the "transpose for throughput" layout), giving
         each chunk's register transform from a zero initial state;
      2. chunk transforms — which compose associatively as
         (shift_count, packed_bits) pairs — are combined across chunks
         with a tiny `associative_scan`, yielding each chunk's exact
         initial registers;
      3. a second `lax.scan` replays the chunks from their exact initial
         state, emitting strand-canonical Wang hashes per position.
    Work is O(L), the compiled program is small (one scan body), and the
    result is bit-exact for any input, including non-ACGT runs of any
    length (no overlap/warm-up approximation).
  * All u64 quantities are (hi, lo) uint32 planes (ops.u64), so the
    kernels run without JAX's x64 mode.
  * Mode-2 emission (hash < threshold) is a pure elementwise filter.  The
    min_span/distinctness filter needs each kept mer's previous/next kept
    neighbor, i.e. it acts on the ~0.4%-density compacted stream — it runs
    after compaction (vectorized, host or device), not as a full-length
    scan: a length-L associative scan would spend device-memory bandwidth
    on 99.6% dead lanes.

Exactness vs the scalar reference is enforced by tests/test_ops_device.py.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import u64
from ..core.spec import ShmmrSpec

U32 = jnp.uint32


def _byte_to_code_table() -> np.ndarray:
    t = np.full(256, 4, dtype=np.uint32)
    t[0:4] = [0, 1, 2, 3]
    for b, c in ((65, 0), (67, 1), (71, 2), (84, 3)):
        t[b] = c
        t[b + 32] = c
    return t


_CODE_TABLE = _byte_to_code_table()


def encode_bases(seqs_u8: jnp.ndarray) -> jnp.ndarray:
    """uint8 bytes -> 2-bit codes (4 = ambiguous), elementwise.

    Implemented with arithmetic selects, NOT a lookup table, so it fuses
    as one elementwise pass with no gather.  Accepts raw 0-3 codes and ACGT/acgt
    (reference table: shmmrutils.rs:426-436)."""
    up = seqs_u8 & jnp.uint8(0xDF)  # fold lowercase onto uppercase
    code = jnp.where(
        seqs_u8 < 4,
        seqs_u8.astype(jnp.uint32),
        jnp.where(
            up == ord("A"),
            0,
            jnp.where(
                up == ord("C"),
                1,
                jnp.where(up == ord("G"), 2, jnp.where(up == ord("T"), 3, 4)),
            ),
        ).astype(jnp.uint32),
    )
    return code


def _mask_pair(v, k: int):
    """Mask a (hi, lo) register pair to k bits."""
    if k >= 32:
        return v[0] & jnp.uint32((1 << (k - 32)) - 1), v[1]
    return jnp.zeros_like(v[0]), v[1] & jnp.uint32((1 << k) - 1)


def _step_registers(state, col_code, k: int):
    """One base step of the rolling registers (reference:
    shmmrutils.rs:459-476).  state/col arrays have shape (lanes,)."""
    valid = col_code < 4
    c = jnp.where(valid, col_code, 0).astype(U32)
    rc = jnp.uint32(3) ^ c
    km1 = k - 1

    def shift_in_f(reg, bit):
        shifted = u64.shl_const(reg, 1)
        return _mask_pair(u64.or_(shifted, (jnp.zeros_like(bit), bit)), k)

    def shift_in_r(reg, bit):
        shifted = u64.shr_const(reg, 1)
        top = u64.shl_const((jnp.zeros_like(bit), bit), km1)
        return _mask_pair(u64.or_(shifted, top), k)

    f0 = shift_in_f(state["f0"], c & 1)
    f1 = shift_in_f(state["f1"], (c >> 1) & 1)
    r0 = shift_in_r(state["r0"], rc & 1)
    r1 = shift_in_r(state["r1"], (rc >> 1) & 1)

    def sel(new, old):
        return u64.where(valid, new, old)

    return dict(
        f0=sel(f0, state["f0"]),
        f1=sel(f1, state["f1"]),
        r0=sel(r0, state["r0"]),
        r1=sel(r1, state["r1"]),
        n=jnp.minimum(state["n"] + valid.astype(U32), jnp.uint32(63)),
    )


def _zero_state(lanes: int):
    z = jnp.zeros((lanes,), dtype=U32)
    zz = (z, z)
    return dict(f0=zz, f1=zz, r0=zz, r1=zz, n=z)


def _combine_transform(a, b, k: int):
    """Compose chunk register transforms.  A transform (n, v) maps
    X -> ((X << n) | v) for forward channels, X -> ((X >> n) | v) for
    reverse channels; n is the clamped count of consumed bases."""
    bn = b["n"]
    out = {"n": jnp.minimum(a["n"] + bn, jnp.uint32(63))}
    for ch in ("f0", "f1"):
        out[ch] = _mask_pair(u64.or_(u64.shl(a[ch], bn), b[ch]), k)
    for ch in ("r0", "r1"):
        out[ch] = _mask_pair(u64.or_(u64.shr(a[ch], bn), b[ch]), k)
    return out


def _hash_cols(state, k: int, r: int):
    """Per-position outputs from the current registers: x (hi,lo) and a
    packed meta plane (bit0 = strand, bit1 = non-palindromic AND full hash
    under the mode-2 threshold, bit2 = palindromic k-mer).  The full
    64-bit hash is consumed inside the scan body — it never touches
    device memory."""
    f0, f1, r0, r1 = state["f0"], state["f1"], state["r0"], state["r1"]
    palindrome = u64.eq(f0, r0) & u64.eq(f1, r1)
    reverse = u64.lt(r0, f0)
    # select the strand-canonical registers BEFORE hashing: one pair of
    # Wang hashes instead of two (the hash dominates the scan body)
    a0 = u64.where(reverse, r0, f0)
    a1 = u64.where(reverse, r1, f1)
    xor_const = u64.from_int(0xAD12CF59, like=f0[0])
    h = u64.xor(u64.wang_hash(a0), u64.wang_hash(u64.xor(a1, xor_const)))
    x = u64.or_(u64.shl_const(h, 8), u64.from_int(k, like=h[0]))
    threshold = u64.from_int(((1 << 64) - 1) >> 4 >> r, like=h[0])
    ok = ~palindrome & u64.lt(h, threshold)
    meta = (
        reverse.astype(U32)
        | (ok.astype(U32) << 1)
        | (palindrome.astype(U32) << 2)
    )
    return x, meta


def _register_walk(code: jnp.ndarray, k: int, r: int, chunk: int):
    """(B, L) codes -> per-position x (hi,lo) and packed meta plane
    (bit0 strand, bit1 ok), all (B, L), via the two-level scan."""
    B, L = code.shape
    nc = L // chunk
    cols = code.reshape(B * nc, chunk).T  # (chunk, lanes)

    # phase 1: per-chunk transform from zero state
    def step1(st, col):
        return _step_registers(st, col, k), None

    agg, _ = jax.lax.scan(step1, _zero_state(B * nc), cols, unroll=4)

    # phase 2 init: exclusive combine of chunk transforms per sequence
    agg_b = jax.tree.map(lambda v: v.reshape(B, nc), agg)
    inc = jax.lax.associative_scan(
        lambda a, b: _combine_transform(a, b, k), agg_b, axis=1
    )

    def exclusive(v):
        return jnp.concatenate(
            [jnp.zeros_like(v[:, :1]), v[:, :-1]], axis=1
        ).reshape(B * nc)

    init = jax.tree.map(exclusive, inc)

    # phase 3: replay with exact initial registers, emitting hashes
    def step2(st, col):
        st = _step_registers(st, col, k)
        x, meta = _hash_cols(st, k, r)
        return st, (x[0], x[1], meta)

    _, outs = jax.lax.scan(step2, init, cols, unroll=4)

    def back(v):  # (chunk, lanes) -> (B, L)
        return v.T.reshape(B, L)

    x_hi, x_lo, meta = (back(v) for v in outs)
    return (x_hi, x_lo), meta


def _register_walk_overlap(code: jnp.ndarray, lengths: jnp.ndarray,
                           k: int, r: int, chunk: int, overlap: int = 64):
    """Single-pass variant of _register_walk: each chunk warms its
    registers up from an `overlap`-base prefix of the previous chunk
    instead of the exact two-level composition: one scan instead of two;
    unroll=4 amortizes the scan's per-step loop overhead (not yet
    measured on the H100).  Exact whenever every overlap window contains >= k
    ACGT bases — i.e. no N-run longer than overlap-k straddling a chunk
    boundary; the returned `inexact` flag reports violations so callers
    can fall back to the exact walk.  Only LIVE chunks (those starting
    before the row's true length) are checked: the padding beyond a
    short row always looks like an N-run but can never produce a
    selected mer, so it must not force the exact rerun."""
    B, L = code.shape
    nc = L // chunk
    core = code.reshape(B, nc, chunk)
    prev_tail = jnp.roll(core, 1, axis=1)[:, :, chunk - overlap :]
    prev_tail = prev_tail.at[:, 0, :].set(jnp.uint32(4))  # no history at seq start
    windows = jnp.concatenate([prev_tail, core], axis=2)  # (B, nc, chunk+OV)

    valid_in_overlap = (prev_tail < 4).sum(axis=2)
    chunk_ids = jax.lax.broadcasted_iota(jnp.int32, (B, nc), 1)
    first_chunk = chunk_ids == 0
    live = chunk_ids * chunk < lengths[:, None]
    inexact = ((valid_in_overlap < k) & ~first_chunk & live).any()

    cols = windows.reshape(B * nc, chunk + overlap).T

    def step(st, col):
        st = _step_registers(st, col, k)
        x, meta = _hash_cols(st, k, r)
        return st, (x[0], x[1], meta)

    _, outs = jax.lax.scan(step, _zero_state(B * nc), cols, unroll=4)

    def back(v):  # (chunk+OV, lanes) -> (B, L), dropping warm-up columns
        return v[overlap:].T.reshape(B, L)

    x_hi, x_lo, meta = (back(v) for v in outs)
    return (x_hi, x_lo), meta, inexact


def _register_walk_overlap_compact(
    code: jnp.ndarray, lengths: jnp.ndarray, k: int, r: int, chunk: int,
    slots: int, overlap: int = 64
):
    """Overlap register walk with the LEVEL-1 rank extraction fused into
    the scan body: each lane keeps a running selected-count and one-hot
    accumulates the (x_hi, x_lo, y_lo) of its first `slots` selected
    mers into a (lanes, slots) carry, so the dense (B, L) hash/meta
    planes never touch device memory and the post-scan transpose/relayout of
    three full-width planes disappears.

    Returns (xh, xl, yl) of shape (B, nc*slots) in the exact
    _rank_extract(block=chunk, slots=slots) layout (per-block valid
    prefix), plus valid, per-block counts' overflow flag, and the
    overlap `inexact` flag."""
    B, L = code.shape
    nc = L // chunk
    core = code.reshape(B, nc, chunk)
    prev_tail = jnp.roll(core, 1, axis=1)[:, :, chunk - overlap:]
    prev_tail = prev_tail.at[:, 0, :].set(jnp.uint32(4))
    windows = jnp.concatenate([prev_tail, core], axis=2)
    valid_in_overlap = (prev_tail < 4).sum(axis=2)
    chunk_ids = jax.lax.broadcasted_iota(jnp.int32, (B, nc), 1)
    first_chunk = chunk_ids == 0
    live = chunk_ids * chunk < lengths[:, None]  # see _register_walk_overlap
    inexact = ((valid_in_overlap < k) & ~first_chunk & live).any()

    lanes = B * nc
    cols = windows.reshape(lanes, chunk + overlap).T
    lane = jnp.arange(lanes, dtype=jnp.int32)
    base_pos = (lane % nc) * chunk            # chunk start position
    len_lane = jnp.repeat(lengths, nc)        # (lanes,)
    slot_ids = jnp.arange(slots, dtype=jnp.int32)[None, :]

    z = jnp.zeros((lanes, slots), dtype=U32)
    init = (
        _zero_state(lanes),
        jnp.zeros((lanes,), dtype=jnp.int32),  # selected count
        z, z, z,
    )
    ts = jnp.arange(chunk + overlap, dtype=jnp.int32)

    def step(carry, inp):
        st, cnt, axh, axl, ayl = carry
        col, t = inp
        st = _step_registers(st, col, k)
        x, meta = _hash_cols(st, k, r)
        pos = base_pos + (t - overlap)
        sel = (
            (t >= overlap) & (pos < len_lane) & (pos >= k)
            & ((meta & 2) != 0)
        )
        y = (pos.astype(U32) << 1) | (meta & 1)
        m = (sel[:, None] & (cnt[:, None] == slot_ids)).astype(U32)
        axh = axh + m * x[0][:, None]
        axl = axl + m * x[1][:, None]
        ayl = ayl + m * y[:, None]
        cnt = cnt + sel.astype(jnp.int32)
        return (st, cnt, axh, axl, ayl), None

    (_, cnt, axh, axl, ayl), _ = jax.lax.scan(
        step, init, (cols, ts), unroll=4
    )
    valid = (slot_ids < cnt[:, None]).reshape(B, nc * slots)
    overflow = (cnt > slots).any()
    return (
        axh.reshape(B, nc * slots),
        axl.reshape(B, nc * slots),
        ayl.reshape(B, nc * slots),
        valid,
        overflow,
        inexact,
    )


@functools.partial(
    jax.jit,
    static_argnames=("k", "r", "min_span", "chunk", "slots", "block2",
                     "slots2"),
)
def sketch_compact_mode2(
    seqs_u8: jnp.ndarray,
    lengths: jnp.ndarray,
    k: int,
    r: int,
    min_span: int,
    chunk: int = 512,
    slots: int = 12,
    block2: int = 512,
    slots2: int = 144,
):
    """Fused mode-2 sketch + two-level compaction: the scan-fused level-1
    extraction (see _register_walk_overlap_compact) followed by the
    level-2 rank extract.  Output layout and semantics are identical to
    sketch_mode2_dense + compact_mers_packed(block=chunk, ...); the
    returned `overflow` flag also covers the overlap-walk `inexact`
    condition — on overflow, rerun via the unfused exact path
    (sketch_mode2_dense(exact=True) + compact_mers_packed with
    SAFE_COMPACT_KW)."""
    from . import pairs as pairs_ops

    B, L = seqs_u8.shape
    assert L % chunk == 0, "pad L to a multiple of chunk"
    code = encode_bases(seqs_u8)
    xh, xl, yl, valid, ovf1, inexact = _register_walk_overlap_compact(
        code, lengths, k, r, chunk, slots
    )
    xh, xl, yl, valid, ovf2 = pairs_ops._rank_extract(
        xh, xl, yl, valid, block2, slots2
    )
    return xh, xl, yl, valid, ovf1 | ovf2 | inexact


@functools.partial(
    jax.jit, static_argnames=("k", "r", "min_span", "chunk", "exact")
)
def sketch_mode2_dense(
    seqs_u8: jnp.ndarray,
    lengths: jnp.ndarray,
    rids: jnp.ndarray,
    k: int,
    r: int,
    min_span: int,
    chunk: int = 512,
    exact: bool = False,
):
    """Mode-2 SHIMMER sketch of a padded batch.

    Args:
      seqs_u8: (B, L) uint8, L a multiple of `chunk` (pad with non-ACGT)
      lengths: (B,) int32 true lengths
      rids:    (B,) uint32 sequence ids
    Returns dict of (B, L) planes: x_hi, x_lo, y_hi, y_lo, selected\n    (pre-min_span mask; apply min_span_filter_np after compaction).
    """
    B, L = seqs_u8.shape
    assert L % chunk == 0, "pad L to a multiple of chunk"
    code = encode_bases(seqs_u8)
    if exact:
        x, meta = _register_walk(code, k, r, chunk)
        inexact = jnp.bool_(False)
    else:
        x, meta, inexact = _register_walk_overlap(code, lengths, k, r, chunk)

    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    in_seq = pos < lengths[:, None]
    selected = in_seq & (pos >= k) & ((meta & 2) != 0)
    y_lo = (pos.astype(U32) << 1) | (meta & 1)

    return dict(
        x_hi=x[0],
        x_lo=x[1],
        y_lo=y_lo,
        y_hi=jnp.broadcast_to(rids[:, None].astype(U32), (B, L)),
        selected=selected,
        inexact=inexact,
    )


def pad_batch(seqs, pad_to=None, multiple: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: list of byte strings -> (B, L) uint8 + lengths, with L
    padded to a multiple of the chunk size."""
    L = max((len(s) for s in seqs), default=0)
    if pad_to is not None:
        L = max(L, pad_to)
    L = max(multiple, ((L + multiple - 1) // multiple) * multiple)
    B = len(seqs)
    arr = np.full((B, L), 0xFF, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(bytes(s), dtype=np.uint8)
        arr[i, : len(b)] = b
        lens[i] = len(b)
    return arr, lens


def min_span_filter_np(x, pos, min_span: int):
    """Vectorized min_span/distinctness filter on a compacted mer stream
    (reference: shmmrutils.rs:536-555).  x: uint64 array, pos: int array.
    Returns a boolean keep mask."""
    n = x.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    keep = np.zeros(n, dtype=bool)
    keep[0] = True
    keep[-1] = True
    if n > 2:
        pd = pos[1:-1] - pos[:-2] > min_span
        nd = pos[2:] - pos[1:-1] > min_span
        dx = (x[1:-1] != x[:-2]) & (x[1:-1] != x[2:])
        keep[1:-1] = pd & nd & dx
    return keep


def sketch_mode2(seqs, rids=None, spec: ShmmrSpec = None, chunk: int = 512):
    """Convenience host API: sketch byte sequences on device, return per-seq
    (x, y) uint64 numpy arrays (compacted), matching the scalar reference.

    Uses the scan-fused device compaction so only the ~L/152-wide
    compacted planes cross the device->host link — the dense planes are
    ~150x more transfer.  Falls back to the exact
    two-level walk + dense download only when the fused path flags an
    overflow (dense mer cluster) or a boundary-straddling N-run."""
    spec = spec or ShmmrSpec(sketch=True)
    assert spec.sketch, "sketch_mode2 requires spec.sketch=True"
    if rids is None:
        rids = list(range(len(seqs)))
    arr, lens = pad_batch(seqs, multiple=chunk)
    xh, xl, yl, valid, ovf = sketch_compact_mode2(
        jnp.asarray(arr),
        jnp.asarray(lens),
        spec.k,
        spec.r,
        spec.min_span,
        chunk,
    )
    if not bool(ovf):
        sel = np.asarray(valid)
        x = (np.asarray(xh, dtype=np.uint64) << np.uint64(32)) | np.asarray(
            xl, dtype=np.uint64
        )
        y_lo = np.asarray(yl, dtype=np.uint64)
    else:
        out = sketch_mode2_dense(
            jnp.asarray(arr),
            jnp.asarray(lens),
            jnp.asarray(np.asarray(rids, dtype=np.uint32)),
            spec.k,
            spec.r,
            spec.min_span,
            chunk,
            exact=True,
        )
        sel = np.asarray(out["selected"])
        x = (
            np.asarray(out["x_hi"], dtype=np.uint64) << np.uint64(32)
        ) | np.asarray(out["x_lo"], dtype=np.uint64)
        y_lo = np.asarray(out["y_lo"], dtype=np.uint64)
    res = []
    for i in range(len(seqs)):
        idx = np.flatnonzero(sel[i])
        xs = x[i, idx]
        pos = (y_lo[i, idx].astype(np.int64)) >> 1
        keep = min_span_filter_np(xs, pos, spec.min_span)
        xs = xs[keep]
        ys = (np.uint64(int(rids[i])) << np.uint64(32)) | y_lo[i, idx][keep]
        res.append((xs, ys))
    return res
