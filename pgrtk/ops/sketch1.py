"""Mode-1 (windowed minimizer) SHIMMER sketching on device.

The reference's mode-1 sketcher is a sequential streaming automaton
(shmmrutils.rs:417-530): a ring of the last w mers, a running minimum, and
two emission paths — B: a new mer <= the running minimum (interior
positions only), A: the running minimum expires (re-scan the window, emit
all ties, rightmost tie becomes the minimum).

Parallel re-derivation (validated bit-exact against the sequential
arbiter; see tests): the automaton's minimum always equals the trailing
w-window minimum with rightmost-tie selection, EXCEPT in the suppressed
boundary region.  Therefore:

  W2[p]      : trailing (w-1)-window min over [p-w+1, p-1]  (the ONLY
               sparse table needed: both rightmost-tie argmin tests
               reduce to value compares against it)
  A-event(q) : q == k+w-1 (warm-up expiry) or x_{q-w} <lex W2[q]
               (min expiry: the leftmost slot strictly beats the rest)
  A-emitted(j): exists q in [j, j+w-1] with A(q) and W[q] == x_j
               <=> leading-w-window max of (A ? W : 0) at j >= x_j
               (W[q] = min(W2[q], x_q), one elementwise combine)
  B-emitted(p): x_p <=lex W2[p] (rightmost tie -> argmin is p itself),
               w+k <= p < len-w+k, and no A at p

The invariant only breaks once a would-be-B is suppressed by the interior
upper bound (p >= len-w+k), so positions after t0 = len-w+k-1 are finished
by a tiny (w-k)-step sequential tail on host.  Windowed min/max run as
binary-lifting sparse tables: log2(w) elementwise shift+combine levels in
the native (B, L) layout (transposes and per-step scans are
layout-hostile here); 64-bit mer keys are (hi, lo) u32 planes with the
position folded in for rightmost-tie argmin.

reduce_shmmr x2 + the min_span filter operate on the emitted stream
(~2/w density) and run in the native library (pgr_reduce_and_filter).
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import ShmmrSpec
from . import sketch as sketch_ops

U32 = jnp.uint32
FF = jnp.uint32(0xFFFFFFFF)


def _lex_min2(a, b):
    """Value-only lex minimum of two (x_hi, x_lo) pairs (equal values
    need no tie-break — either operand yields the same value)."""
    ah, al = a
    bh, bl = b
    a_less = (ah < bh) | ((ah == bh) & (al <= bl))
    return jnp.where(a_less, ah, bh), jnp.where(a_less, al, bl)


def _shift_right(v, n, fill):
    """v[:, t] <- v[:, t-n] with fill on the left (shift toward higher t)."""
    if n == 0:
        return v
    return jnp.pad(v, [(0, 0), (n, 0)], constant_values=fill)[:, : v.shape[1]]


def _shift_left(v, n, fill):
    if n == 0:
        return v
    return jnp.pad(v, [(0, 0), (0, n)], constant_values=fill)[:, n:]


def _sparse_table(channels, win, combine, fills, leading=True):
    """Binary-lifting sparse table: returns the `combine` over the
    leading window [p, p+win-1] for every position, as pure elementwise
    shift+combine levels in the native (B, L) layout (no transposes, no
    scans)."""
    cur = channels
    j = 1
    while 2 * j <= win:
        shifted = tuple(
            _shift_left(v, j, f) for v, f in zip(cur, fills)
        )
        cur = combine(cur, shifted)
        j *= 2
    # cur = window of size j starting at p; cover [p, p+win-1] with two
    # overlapping windows of size j
    rest = win - j
    shifted = tuple(_shift_left(v, rest, f) for v, f in zip(cur, fills))
    return combine(cur, shifted)


def _trailing_window_min(xh, xl, valid, win: int):
    """Trailing-window value-only lex-min of each (B, L) position over
    [t-win+1, t] (0xFFFFFFFF pairs where the window is empty).

    No argmin channel: the two rightmost-tie argmin consumers reduce to
    value comparisons against the (w-1)-window min (see
    sketch_mode1_dense), which drops a third of the sparse-table
    shift/select traffic."""
    h = jnp.where(valid, xh, FF)
    lo = jnp.where(valid, xl, FF)
    lead = _sparse_table((h, lo), win, _lex_min2, (FF, FF))
    Wh, Wl = (_shift_right(v, win - 1, FF) for v in lead)
    return Wh, Wl


def _lex_max2(a, b):
    ah, al = a
    bh, bl = b
    a_ge = (ah > bh) | ((ah == bh) & (al >= bl))
    return jnp.where(a_ge, ah, bh), jnp.where(a_ge, al, bl)


def _leading_window_max(mh, ml, win: int):
    """Leading-window lex-max over [t, t+win-1] of (hi, lo) u32 pairs
    (zeros act as -inf)."""
    Z = jnp.uint32(0)
    return _sparse_table((mh, ml), win, _lex_max2, (Z, Z))


@functools.partial(jax.jit, static_argnames=("w", "k", "chunk"))
def sketch_mode1_dense(
    seqs_u8: jnp.ndarray,
    lengths: jnp.ndarray,
    k: int,
    w: int,
    chunk: int = 512,
):
    """Raw mode-1 minimizer emission mask for a padded batch.

    Returns dict of (B, L) planes: x_hi, x_lo, meta(bit0=strand),
    emitted (bool, exact for positions <= t0 = len-w+k-1), plus
    palindrome_seen ((B,) bool: caller must fall back for those
    sequences — their emission stream is no longer positionally dense).
    """
    B, L = seqs_u8.shape
    code = sketch_ops.encode_bases(seqs_u8)
    # reuse the mode-2 register walk; r value irrelevant for x/meta planes
    x, meta = sketch_ops._register_walk(code, k, 4, chunk)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    in_seq = pos < lengths[:, None]
    have = in_seq & (pos >= k)
    # palindromic k-mers (strand-ambiguous, skipped by the reference) make
    # the emission stream non-dense; meta bit2 carries the flag
    palindrome = (meta & 4) != 0
    have = have & ~palindrome
    palindrome_seen = (palindrome & in_seq & (pos >= k)).any(axis=1)

    # (w-1)-window trailing min, shifted to cover [p-w+1, p-1] at p —
    # the single table both argmin consumers reduce to (value compares
    # replace the old 3rd rightmost-tie argmin channel)
    W2h, W2l = _trailing_window_min(x[0], x[1], have, w - 1)
    W2h_p = _shift_right(W2h, 1, FF)
    W2l_p = _shift_right(W2l, 1, FF)

    posu = pos.astype(U32)
    t0 = jnp.minimum(lengths - w + k - 1, lengths - 1)[:, None]

    hv_h = jnp.where(have, x[0], FF)
    hv_l = jnp.where(have, x[1], FF)
    # full w-window min at p = min([p-w+1, p-1], x[p])
    Wh, Wl = _lex_min2((W2h_p, W2l_p), (hv_h, hv_l))

    # A events
    first_a = posu == jnp.uint32(k + w - 1)
    # min expiry: rightmost argmin of the window ending p-1 sits at its
    # leftmost slot p-w  <=>  x[p-w] <lex min(x[p-w+1 .. p-1])
    # (a later tie would steal the rightmost argmin)
    xw_h = _shift_right(hv_h, w, FF)
    xw_l = _shift_right(hv_l, w, FF)
    a_expire = (
        ((xw_h < W2h_p) | ((xw_h == W2h_p) & (xw_l < W2l_p)))
        & (pos >= k + w)
        & (pos <= t0)
    )
    A = (first_a & (pos <= jnp.maximum(t0, k + w - 1))) | a_expire
    # the warm-up A requires the stream to actually reach w mers; with a
    # dense stream that's pos == k+w-1 < len
    A = A & in_seq

    # A-emitted: leading-window max of (A ? W : 0) >= x
    mh = jnp.where(A, Wh, 0)
    ml = jnp.where(A, Wl, 0)
    Mh, Ml = _leading_window_max(mh, ml, w)
    m_nonzero = (Mh | Ml) != 0
    a_emit = (
        have
        & m_nonzero
        & ((Mh > x[0]) | ((Mh == x[0]) & (Ml >= x[1])))
    )

    # B-emitted: rightmost-tie argmin of the trailing w-window is p
    # itself  <=>  x[p] <=lex min(x[p-w+1 .. p-1])
    b_emit = (
        have
        & ((hv_h < W2h_p) | ((hv_h == W2h_p) & (hv_l <= W2l_p)))
        & (pos >= w + k)
        & (pos <= t0)
        & ~A
    )

    emitted = (a_emit | b_emit) & (pos <= t0)
    return dict(
        x_hi=x[0],
        x_lo=x[1],
        meta=meta,
        emitted=emitted,
        palindrome_seen=palindrome_seen,
    )


@functools.partial(jax.jit, static_argnames=("k", "w", "chunk"))
def _mode1_compacted(seqs_u8, lengths, k, w, chunk=512):
    """sketch_mode1_dense + on-device rank-extract compaction of the
    emitted stream (~4% dense), plus a tiny per-sequence tail slice of
    the raw mer planes.  Only the compacted planes cross the
    device->host link: the dense (B, L) planes are ~25x more bytes."""
    from . import pairs as pairs_ops

    out = sketch_mode1_dense(seqs_u8, lengths, k, w, chunk)
    B, L = seqs_u8.shape
    pos = jax.lax.broadcasted_iota(U32, (B, L), 1)
    posstrand = (pos << 1) | (out["meta"] & 1)
    SLOTS = 64  # per-512-block capacity; low-complexity runs overflow
    planes, cvalid, _ovf = pairs_ops._rank_extract_planes(
        (out["x_hi"], out["x_lo"], posstrand), out["emitted"], 512, SLOTS
    )
    nb = -(-L // 512)
    cnt = jnp.pad(
        out["emitted"], [(0, 0), (0, nb * 512 - L)]
    ).reshape(B, nb, 512).sum(axis=2)
    ovf_row = (cnt > SLOTS).any(axis=1)  # per-seq scalar-fallback flag
    TW = 2 * w
    starts = jnp.clip(lengths - TW, 0)
    tails = [
        jax.vmap(
            lambda v, s: jax.lax.dynamic_slice(v, (s,), (TW,))
        )(plane, starts)
        for plane in (out["x_hi"], out["x_lo"], out["meta"])
    ]
    return dict(
        c_hi=planes[0], c_lo=planes[1], c_posstrand=planes[2],
        c_valid=cvalid,
        tail_hi=tails[0], tail_lo=tails[1], tail_meta=tails[2],
        tail_base=starts,
        palindrome_seen=out["palindrome_seen"],
        overflow=ovf_row,
    )


def sketch_mode1_arrays(
    seqs: Sequence[bytes], rids=None, spec: ShmmrSpec = None, chunk: int = 512
):
    """Host API: exact mode-1 sketch via the device emission kernel + the
    host tail + native reduce/filter, returning per-seq (x, y) uint64
    ARRAYS end-to-end (no per-mer Python tuples — the tuple path's
    marshalling cost exceeded the device kernel itself at batch scale).
    Falls back to the native scalar sketcher per-sequence when a
    palindromic k-mer is seen."""
    from ..native import api as native

    spec = spec or ShmmrSpec(sketch=False)
    assert not spec.sketch
    if rids is None:
        rids = list(range(len(seqs)))
    w, k = spec.w, spec.k
    arr, lens = sketch_ops.pad_batch(seqs, multiple=chunk)
    out = _mode1_compacted(
        jnp.asarray(arr), jnp.asarray(lens), k, w, chunk
    )
    palin = np.asarray(out["palindrome_seen"]) | np.asarray(
        out["overflow"]
    )  # overflow: same per-sequence scalar-fallback contract
    # compacted planes only cross the device->host link (the emitted
    # stream is ~4% dense)
    c_hi = np.asarray(out["c_hi"], np.uint64)
    c_lo = np.asarray(out["c_lo"], np.uint64)
    c_ps = np.asarray(out["c_posstrand"])  # pos<<1 | strand, u32
    c_valid = np.asarray(out["c_valid"])
    # tail slice of the raw mer planes (only needed when w > k: the
    # suppressed boundary region; tiny)
    tail_x = (
        np.asarray(out["tail_hi"], np.uint64) << np.uint64(32)
    ) | np.asarray(out["tail_lo"], np.uint64)
    tail_strand = (np.asarray(out["tail_meta"]) & 1).astype(np.uint64)
    tail_base = np.asarray(out["tail_base"])

    def scalar_arrays(rid, seq):
        mers = native.sequence_to_shmmrs(rid, seq, spec)
        if not mers:
            z = np.zeros(0, dtype=np.uint64)
            return z, z
        a = np.asarray(mers, dtype=np.uint64)
        return a[:, 0], a[:, 1]

    results = []
    for i, seq in enumerate(seqs):
        L = len(seq)
        rid = int(rids[i])
        t0 = min(L - w + k - 1, L - 1)
        if palin[i] or t0 < k + w - 1:
            # palindromic k-mer (non-dense emission stream) or too short
            # for the parallel path: scalar fallback for this sequence
            results.append(scalar_arrays(rid, seq))
            continue
        vm = c_valid[i]
        em_pos = (c_ps[i][vm] >> 1).astype(np.int64)
        em_x = (c_hi[i][vm] << np.uint64(32)) | c_lo[i][vm]
        em_strand = (c_ps[i][vm] & 1).astype(np.uint64)
        # sequential tail from the invariant state at t0 (w > k only) —
        # runs on the tiny tail slice; collects emitted POSITIONS
        tb = int(tail_base[i])
        txs = tail_x[i]

        def xval(p):
            return int(txs[p - tb])

        tail_pos = []
        if t0 + 1 < L:
            w_lo = max(0, t0 - w + 1)
            win = txs[w_lo - tb : t0 + 1 - tb]
            mn = win.min()
            ties = np.flatnonzero(win == mn)
            min_pos = int(ties[-1]) + w_lo
            min_x = int(mn)
            mdist = t0 - min_pos
            for p in range(t0 + 1, L):
                xp = xval(p)
                if mdist == w - 1:
                    lo = p - w + 1
                    sub = txs[lo - tb : p + 1 - tb]
                    mn2 = int(sub.min())
                    for j in np.flatnonzero(sub == mn2):
                        jj = lo + int(j)
                        tail_pos.append(jj)
                        min_pos = jj
                    min_x = mn2
                    mdist = p - min_pos
                elif xp <= min_x and w + k <= p < L - w + k:
                    tail_pos.append(p)
                    min_pos = p
                    min_x = xp
                    mdist = 0
                else:
                    mdist += 1
        if tail_pos:
            tp = np.asarray(tail_pos, dtype=np.int64)
            sx = np.concatenate([em_x, tail_x[i][tp - tb]])
            sy_pos = np.concatenate([em_pos, tp])
            sstrand = np.concatenate(
                [em_strand, tail_strand[i][tp - tb]]
            )
        else:
            sx, sy_pos, sstrand = em_x, em_pos, em_strand
        sy = (
            (np.uint64(rid) << np.uint64(32))
            | (sy_pos.astype(np.uint64) << np.uint64(1))
            | sstrand
        )
        results.append(
            native.reduce_and_filter_arrays(
                sx, sy, spec.r, spec.min_span, False
            )
        )
    return results


def sketch_mode1(
    seqs: Sequence[bytes], rids=None, spec: ShmmrSpec = None, chunk: int = 512
) -> List[List[Tuple[int, int]]]:
    """Tuple-list variant of sketch_mode1_arrays (legacy callers)."""
    return [
        list(zip(xs.tolist(), ys.tolist()))
        for xs, ys in sketch_mode1_arrays(seqs, rids, spec, chunk)
    ]
