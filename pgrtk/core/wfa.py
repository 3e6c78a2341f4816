"""WFA gap-affine alignment + variant extraction.

wfa_align_bases drives the native WFA kernel (the reference links the
wavefront-aln crate at pgr-db/src/aln.rs:244-267); the pair-map / variant
aggregation below re-derives the reference post-processing exactly
(aln.rs:269-453).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple


def wfa_align_bases(
    target_str: str,
    query_str: str,
    max_wf_length: int,
    mismatch_penalty: int,
    open_penalty: int,
    extension_penalty: int,
    max_steps: int = 1024,
) -> Optional[Tuple[str, str]]:
    """Returns (aligned_target, aligned_query) with '-' gaps, or None if
    the alignment does not complete within max_steps score steps
    (reference: aln.rs:244-267; the reference caps step_all at 1024)."""
    from ..native import api as native

    lib = native._load()
    if not hasattr(lib, "pgr_wfa_align_configured"):
        lib.pgr_wfa_align.restype = ctypes.c_int32
        lib.pgr_wfa_align.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_uint32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
        ]
        lib.pgr_wfa_align_configured = True
    t = target_str.encode() if isinstance(target_str, str) else bytes(target_str)
    q = query_str.encode() if isinstance(query_str, str) else bytes(query_str)
    ta = ctypes.c_char_p()
    qa = ctypes.c_char_p()
    score = lib.pgr_wfa_align(
        t,
        len(t),
        q,
        len(q),
        max_wf_length,
        mismatch_penalty,
        open_penalty,
        extension_penalty,
        max_steps,
        ctypes.byref(ta),
        ctypes.byref(qa),
    )
    if score < 0:
        return None
    t_aln = ta.value.decode()
    q_aln = qa.value.decode()
    lib.pgr_free(ta)
    lib.pgr_free(qa)
    return t_aln, q_aln


def wfa_aln_pair_map(
    aln_target_str: str, aln_query_str: str
) -> List[Tuple[int, int, str]]:
    """Per-column (t_pos, q_pos, 'M/X/I/D') map (reference: aln.rs:269-301)."""
    out = []
    t_pos = 0
    q_pos = 0
    for tb, qb in zip(aln_target_str, aln_query_str):
        t = "-"
        if tb == "-":
            t = "I"
            new_t = t_pos
        else:
            new_t = t_pos + 1
        if qb == "-":
            t = "D"
            new_q = q_pos
        else:
            new_q = q_pos + 1
        if tb == qb:
            t = "M"
        if tb != qb and tb != "-" and qb != "-":
            t = "X"
        out.append((t_pos, q_pos, t))
        t_pos = new_t
        q_pos = new_q
    return out


def get_variants_from_aln_pair_map(
    aln_pairs, target_str: str, query_str: str
) -> List[Tuple[int, int, str, str, str]]:
    """Aggregate runs of X/I/D into VCF-like records
    (reference: aln.rs:303-387)."""
    current: List[Tuple[str, str, str]] = []
    variants: List[Optional[Tuple[int, int, str, str, str]]] = []

    def aggregate(previous_match, cur):
        t_seg = "".join(v[0] for v in cur).replace("-", "").strip()
        q_seg = "".join(v[1] for v in cur).replace("-", "").strip()
        t_len, q_len = len(t_seg), len(q_seg)
        if t_len > q_len:
            v_type = "I"
        elif t_len < q_len:
            v_type = "D"
        else:
            v_type = "X"
        if v_type == "X":
            return (
                previous_match[0] + 1,
                previous_match[1] + 1,
                "X",
                t_seg,
                q_seg,
            )
        return (
            previous_match[0],
            previous_match[1],
            v_type,
            previous_match[3] + t_seg,
            previous_match[4] + q_seg,
        )

    previous_match = (0, 0, "U", "-", "-")
    for t_pos, q_pos, t in aln_pairs:
        if t == "M":
            t_char = target_str[t_pos]
            q_char = query_str[q_pos]
            if current:
                variants.append(aggregate(previous_match, current))
            current = []
            previous_match = (t_pos, q_pos, "M", t_char, q_char)
        elif t == "X":
            current.append((target_str[t_pos], query_str[q_pos], t))
        elif t == "I":
            current.append(("-", query_str[q_pos], t))
        elif t == "D":
            current.append((target_str[t_pos], "-", t))
    if current:
        variants.append(aggregate(previous_match, current))
    return [v for v in variants if v is not None]


def _variants_from_reversed_alignment(
    res, target_str: bytes, query_str: bytes, left_padding: int
):
    """Shared post-processing of a reversed-suffix alignment: restore
    forward coordinates and aggregate variants (aln.rs:390-453)."""
    if res is None:
        return None
    t_aln, q_aln = res
    r_t_len = len(target_str) - left_padding
    r_q_len = len(query_str) - left_padding
    t_len_m1 = left_padding + r_t_len - 1
    q_len_m1 = left_padding + r_q_len - 1
    aln_pairs = wfa_aln_pair_map(t_aln, q_aln)
    for delta in range(left_padding):
        aln_pairs.append((r_t_len + delta, r_q_len + delta, "M"))
    aln_pairs = [
        (t_len_m1 - tp, q_len_m1 - qp, c) for tp, qp, c in aln_pairs
    ]
    aln_pairs.reverse()
    return get_variants_from_aln_pair_map(
        aln_pairs, target_str.decode(), query_str.decode()
    )


def get_variant_segments(
    target_str: bytes,
    query_str: bytes,
    left_padding: int,
    max_wf_length: Optional[int],
    mismatch_penalty: int,
    open_penalty: int,
    extension_penalty: int,
):
    """Left-aligned variant extraction: align the *reversed* suffixes so
    gaps land left, then restore forward coordinates
    (reference: aln.rs:390-453)."""
    if isinstance(target_str, str):
        target_str = target_str.encode()
    if isinstance(query_str, str):
        query_str = query_str.encode()
    len_diff = abs(len(query_str) - len(target_str))
    if max_wf_length is None:
        max_wf_length = max(2 * len_diff, 128)

    r_t = target_str[left_padding:][::-1].decode()
    r_q = query_str[left_padding:][::-1].decode()
    res = wfa_align_bases(
        r_t,
        r_q,
        max_wf_length,
        mismatch_penalty,
        open_penalty,
        extension_penalty,
    )
    return _variants_from_reversed_alignment(
        res, target_str, query_str, left_padding
    )


def batch_get_variant_segments(
    pairs,
    left_padding: int,
    max_wf_length: int,
    mismatch_penalty: int,
    open_penalty: int,
    extension_penalty: int,
    force_device=None,
    threads: Optional[int] = None,
):
    """get_variant_segments over many (target, query) byte pairs at once.

    Default routing is the HOST path with a length-based
    serial/threaded dispatch (bench_wfa.py --sweep): the native call
    releases the GIL, but pool overhead and GIL re-acquisition make
    SERIAL win on short segments and the THREAD pool from a mean
    segment length of ~5 kb (crossover measured on a 4-CPU host).
    `threads` caps the pool like the reference's rayon thread flag.
    The device kernel is opt-in: pass force_device="device" to run it
    (bit-exact to the scalar arbiter, per-segment host fallback).
    Returns a list of per-pair variant lists (None entries where the
    alignment did not complete)."""
    pairs = [
        (
            t.encode() if isinstance(t, str) else bytes(t),
            q.encode() if isinstance(q, str) else bytes(q),
        )
        for t, q in pairs
    ]
    rev = [
        (t[left_padding:][::-1], q[left_padding:][::-1]) for t, q in pairs
    ]
    from ..utils import dispatch

    total = sum(len(t) + len(q) for t, q in rev)
    # device WFA is opt-in (force_device="device"): the forward kernel's
    # extend step re-reads the full (G, 2L, L) run-length plane every
    # score step, and it lost to the threaded native host path on the
    # earlier accelerator (not yet measured on the H100), so production
    # batches route to the host
    if dispatch.use_device(
        total, forced=force_device or "host", what="wfa", min_bases=8192
    ):
        from ..ops import wfa as dev_wfa

        aligned = dev_wfa.batch_wfa_align(
            rev, max_wf_length, mismatch_penalty, open_penalty,
            extension_penalty,
        )
    else:
        from concurrent.futures import ThreadPoolExecutor

        def _one(tq):
            t, q = tq
            return wfa_align_bases(
                t.decode(), q.decode(), max_wf_length, mismatch_penalty,
                open_penalty, extension_penalty,
            )

        # measured crossover (docstring): the pool only amortizes its
        # GIL/queue overhead once per-segment C++ time is large enough,
        # i.e. mean segment length >= ~5 kb
        mean_len = (
            sum(max(len(t), len(q)) for t, q in rev) / len(rev)
            if rev else 0
        )
        if len(rev) > 1 and mean_len >= 5000:
            with ThreadPoolExecutor(max_workers=threads) as ex:
                aligned = list(ex.map(_one, rev))
        else:
            aligned = [_one(tq) for tq in rev]
    return [
        _variants_from_reversed_alignment(res, t, q, left_padding)
        for res, (t, q) in zip(aligned, pairs)
    ]
