"""Batched gap-affine wavefront alignment (WFA) on device.

The SV pipeline aligns thousands of independent gap segments
(pgr-get-sv-candidate-regions; reference caps the wavefront at 384
diagonals, pgr-bin/src/bin/pgr-get-sv-candidate-regions.rs:401-409).
The host arbiter (native/src/wfa.cc) aligns one segment per thread; this
kernel aligns G segments simultaneously, each wavefront occupying one
row, and is BIT-exact to the arbiter for every segment it completes
(others fall back to the host path).

Device mapping — no gathers anywhere:

  * the extend step's sequence comparisons become a precomputed match
    RUN-LENGTH plane runlen[g, d, i] = length of the exact-match run
    starting at target position i on diagonal d.  The shifted-query
    planes behind it are built by log-doubling (10 static power-of-two
    shifts, elementwise), and run lengths by jump-pointer doubling — the
    same trick as ops/pairs._next_valid.
  * per score step, extension = a masked reduction over the i axis
    (iota == offset), all diagonals of all segments at once.
  * wavefronts live in ABSOLUTE diagonal coordinates (a fixed (G, 2L)
    plane), so the M/I/D recurrences are static shifts; the arbiter's
    adaptive trim (keep max_wf_length diagonals around the best-progress
    diagonal) becomes a mask, with lo/hi tracked per wavefront.

The forward pass records the M wavefront per score (i16, -1 = no entry)
plus the [lo, hi] window; the host reconstructs I/D from the recurrences
(cheap numpy) and runs a backtrace that mirrors wfa.cc:162-257 branch
for branch, so the gapped strings are identical to the arbiter's.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

KNULL = -(1 << 20)       # device "no entry" (room for +1 arithmetic)
HNULL = -1               # history "no entry" (offsets are >= 0)


def _shifted_query_planes(q: jnp.ndarray, L: int) -> jnp.ndarray:
    """(G, L) u8 -> (G, 2L, L) u8 where plane d holds q shifted right by
    (d - L) bases (fill 0xFF), i.e. shiftq[g, d, i] = q[g, i - (d - L)].
    Built with log2(2L) power-of-two shifts — no gather."""
    G = q.shape[0]

    def shr(v, s):
        # shift right by s along the last axis, fill 0xFF
        pad = jnp.full(v.shape[:-1] + (s,), 255, dtype=jnp.uint8)
        return jnp.concatenate([pad, v[..., :-s]], axis=-1)

    def shl(v, s):
        pad = jnp.full(v.shape[:-1] + (s,), 255, dtype=jnp.uint8)
        return jnp.concatenate([v[..., s:], pad], axis=-1)

    rows = q[:, None, :]  # covers shift {0}
    right = rows  # will cover shifts [0, L), ascending
    size = 1
    while size < L:
        right = jnp.concatenate([right, shr(right, size)], axis=1)
        size *= 2
    left = rows  # will cover shifts [-(L-1), 0], ascending
    size = 1
    while size < L:
        left = jnp.concatenate([shl(left, size), left], axis=1)
        size *= 2
    # doubling lands on next_pow2(L) rows; slice to exactly L shifts so
    # non-power-of-two L (the sweep's padded segment caps) stays (G,2L,L)
    right = right[:, :L, :]
    left = left[:, -L:, :]
    # assemble d in [0, 2L) <-> shift d - L in [-L, L); the shift -L row
    # is entirely out of range (j = i + L >= L) -> all fill
    minus_L = jnp.full((G, 1, L), 255, dtype=jnp.uint8)
    return jnp.concatenate([minus_L, left[:, :-1, :], right], axis=1)


def _run_length_planes(match: jnp.ndarray, L: int) -> jnp.ndarray:
    """(G, D, L) bool -> (G, D, L) i16: length of the all-True run
    starting at each position (jump-pointer doubling, i16 throughout —
    runs are <= L <= 2^15 and the plane is the kernel's biggest device-memory
    resident, so narrow math halves the build traffic)."""
    r = match.astype(jnp.int16)
    size = 1
    while size < L:
        shifted = jnp.concatenate(
            [r[..., size:], jnp.zeros(r.shape[:-1] + (size,), jnp.int16)],
            axis=-1,
        )
        r = r + jnp.where(r == jnp.int16(size), shifted, jnp.int16(0))
        size *= 2
    return r


@functools.partial(
    jax.jit,
    static_argnames=(
        "L", "S_max", "max_wf_length", "x", "o", "e", "band_l"
    ),
)
def wfa_forward_batch(
    t_batch: jnp.ndarray,
    q_batch: jnp.ndarray,
    n: jnp.ndarray,
    m: jnp.ndarray,
    L: int = 512,
    S_max: int = 256,
    max_wf_length: int = 384,
    x: int = 3,
    o: int = 3,
    e: int = 1,
    band_l: int = 0,  # 0 = no banding (any value >= L is equivalent)
):
    """Forward WFA over G segment pairs.

    The extend step reads the precomputed run-length plane with one
    masked i16 reduction per step by default; band_l < L switches to a
    per-segment offset band with a sticky `band_overflow` spread flag
    (host-fallback contract) — opt-in only: measured SV-segment offset
    spreads equal the match-run lengths, so banding mostly buys
    fallbacks (see extend()).  The forward pass is dominated by the
    one-time run-length plane BUILD, not the loop.  Production routes
    gap segments to the host (core/wfa.py); the device kernel is opt-in
    and not yet measured on the H100.

    Args:
      t_batch, q_batch: (G, L) u8 padded sequences
      n, m: (G,) i32 true lengths (<= L)
    Returns dict (history arrays carry K_STEPS=8 extra rows because the
    while_loop advances 8 score steps per iteration, so final_s can
    overshoot S_max by up to 7 — such completions are exact DP results):
      m_hist : (S_max + 9, G, 2L) i16 — M wavefront per score (-1 = null)
      lo_hist, hi_hist : (S_max + 9, G) i16 — per-score window
      final_s : (G,) i32 — completing score, or -1 (host fallback needed)
      band_overflow : (G,) bool — fell back due to offset spread
    """
    G = t_batch.shape[0]
    D = 2 * L
    Lb = min(band_l, L) if band_l > 0 else L
    karr = jnp.arange(D, dtype=jnp.int32) - L  # absolute diagonal per slot

    # ---- match run-length planes (the entire extend step, precomputed)
    shiftq = _shifted_query_planes(q_batch, L)  # (G, D, L)
    i_iota = jnp.arange(L, dtype=jnp.int32)
    j_idx = i_iota[None, None, :] - karr[None, :, None]  # j = i - k
    in_bounds = (
        (i_iota[None, None, :] < n[:, None, None])
        & (j_idx >= 0)
        & (j_idx < m[:, None, None])
    )
    match = (shiftq == t_batch[:, None, :]) & in_bounds
    runlen = _run_length_planes(match, L)  # (G, D, L) i16

    i16_iota = jnp.arange(L, dtype=jnp.int32)
    lb_iota = jnp.arange(Lb, dtype=jnp.int32)

    def extend(off, lo, hi):
        """off: (G, D) i32 entry offsets (< 0 = no entry); lo/hi unused.
        Returns (extended offsets, out-of-band flag (G,)).

        Default (band_l >= L): one masked i16 reduction over the full
        run-length plane.  With band_l < L, reads only an offset band
        per segment — measured on real SV segments this LOSES: wavefront
        offset spreads equal the match-run lengths (hundreds of bases at
        SV similarity, 210 observed vs Lb=128), so ~1/3 of segments
        raise the spread flag and pay double (device + host fallback).
        Banding stays available for high-divergence workloads whose
        spreads are score-bounded."""
        live = off >= 0
        if Lb >= L:
            sel = i16_iota[None, None, :] == off[:, :, None]
            run = jnp.where(sel, runlen, jnp.int16(0)).sum(
                axis=2, dtype=jnp.int32
            )
            return off + run, jnp.zeros((G,), jnp.bool_)
        mn = jnp.min(jnp.where(live, off, jnp.int32(L)), axis=1)
        ob = jnp.clip(mn, 0, max(0, L - Lb))
        rl_b = jax.vmap(
            lambda v, s: jax.lax.dynamic_slice(v, (0, s), (D, Lb))
        )(runlen, ob)  # (G, D, Lb)
        rel = off - ob[:, None]  # (G, D)
        sel = lb_iota[None, None, :] == rel[:, :, None]
        run = jnp.where(sel, rl_b, jnp.int16(0)).sum(
            axis=2, dtype=jnp.int32
        )
        # a live lookup outside the offset band cannot be served exactly
        oob = jnp.any(live & (rel >= Lb), axis=1)
        return off + run, oob

    NEG = jnp.int32(KNULL)
    ring = max(x, o + e) + 1

    def empty_plane():
        return jnp.full((G, D), NEG, dtype=jnp.int32)

    # ring buffers: index s % ring
    M0 = empty_plane()
    k_end = n - m  # (G,)
    at_kend = karr[None, :] == k_end[:, None]  # (G, D)

    # s = 0: M(0) = extend(0, 0) on diagonal 0 only
    lo0 = jnp.zeros((G,), jnp.int32)
    hi0 = jnp.zeros((G,), jnp.int32)
    off0 = jnp.broadcast_to(
        jnp.where(karr[None, :] == 0, 0, -1), (G, D)
    )
    ext0, _oob0 = extend(off0, lo0, hi0)
    M0 = jnp.where(karr[None, :] == 0, ext0, NEG)
    done0 = (
        jnp.sum(jnp.where(at_kend, M0, 0), axis=1) >= n
    ) & (k_end == 0)

    def hist_plane(Mp):
        return jnp.where(Mp <= NEG, -1, Mp).astype(jnp.int16)

    # K extra history rows: the while_loop advances K score steps per
    # iteration (8x fewer latency-bound loop dispatches), so s can
    # overshoot S_max by up to K-1 — completions there are still exact
    # DP results and stay in bounds
    K_STEPS = 8
    m_hist = jnp.full((S_max + K_STEPS + 1, G, D), -1, dtype=jnp.int16)
    m_hist = m_hist.at[0].set(hist_plane(M0))
    lo_hist = jnp.zeros((S_max + K_STEPS + 1, G), dtype=jnp.int16)
    hi_hist = jnp.full((S_max + K_STEPS + 1, G), -1, dtype=jnp.int16)
    hi_hist = hi_hist.at[0].set(0)

    Mr = jnp.full((ring, G, D), NEG, dtype=jnp.int32).at[0].set(M0)
    Ir = jnp.full((ring, G, D), NEG, dtype=jnp.int32)
    Dr = jnp.full((ring, G, D), NEG, dtype=jnp.int32)
    lor = jnp.zeros((ring, G), jnp.int32).at[0].set(lo0)
    hir = jnp.full((ring, G), -1, jnp.int32).at[0].set(hi0)
    # empty wavefront sentinel: lo=1, hi=0 for ring slots not yet written
    lor = lor.at[1:].set(1)
    final_s = jnp.where(done0, 0, -1)
    band_flag = jnp.zeros((G,), dtype=jnp.bool_)

    def shift_k_plus(v):   # value at k-1: shift plane right along k axis
        return jnp.concatenate(
            [jnp.full((G, 1), NEG, jnp.int32), v[:, :-1]], axis=1
        )

    def shift_k_minus(v):  # value at k+1
        return jnp.concatenate(
            [v[:, 1:], jnp.full((G, 1), NEG, jnp.int32)], axis=1
        )

    half = max_wf_length // 2

    def cond(carry):
        s, band_flag, final_s = carry[0], carry[-2], carry[-1]
        return (s <= S_max) & jnp.any((final_s < 0) & ~band_flag)

    def body(carry):
        (s, Mr, Ir, Dr, lor, hir, m_hist, lo_hist, hi_hist, band_flag,
         final_s) = carry
        sx = (s - x) % ring
        soe = (s - o - e) % ring
        se = (s - e) % ring
        has_x = s >= x
        has_oe = s >= o + e
        has_e = s >= e
        Mx = jnp.where(has_x, Mr[sx], NEG)
        Moe = jnp.where(has_oe, Mr[soe], NEG)
        Ie = jnp.where(has_e, Ir[se], NEG)
        De = jnp.where(has_e, Dr[se], NEG)

        # new window from non-empty sources
        def src_win(avail, idx):
            l = jnp.where(avail, lor[idx], 1)
            h = jnp.where(avail, hir[idx], 0)
            ok = l <= h
            return (
                jnp.where(ok, l - 1, jnp.int32(2 * L)),
                jnp.where(ok, h + 1, jnp.int32(-2 * L)),
            )

        lx, hx = src_win(has_x, sx)
        loe, hoe = src_win(has_oe, soe)
        le_, he_ = src_win(has_e, se)
        lo_new = jnp.minimum(jnp.minimum(lx, loe), le_)
        hi_new = jnp.maximum(jnp.maximum(hx, hoe), he_)
        nonempty = lo_new <= hi_new
        in_win = (karr[None, :] >= lo_new[:, None]) & (
            karr[None, :] <= hi_new[:, None]
        )

        ins = jnp.maximum(shift_k_plus(Moe), shift_k_plus(Ie))
        ins = jnp.where(ins > NEG, ins + 1, NEG)
        dels = jnp.maximum(shift_k_minus(Moe), shift_k_minus(De))
        mm = jnp.where(Mx > NEG, Mx + 1, NEG)
        mm = jnp.maximum(mm, jnp.maximum(ins, dels))
        # bounds check (wfa.cc:116): out-of-range entry -> null
        yy = mm - karr[None, :]
        ok = (
            (mm > NEG)
            & (mm >= 0)
            & (mm <= n[:, None])
            & (yy >= 0)
            & (yy <= m[:, None])
        )
        mm_ok = jnp.where(ok & in_win, mm, NEG)
        ext, oob = extend(
            jnp.where(mm_ok > NEG, mm_ok, -1), lo_new, hi_new
        )
        # an out-of-band lookup under-extends (run contributes 0) — never
        # a spurious completion, so flagging the row for host fallback is
        # sufficient; its remaining device steps are discarded
        band_flag = band_flag | (oob & (final_s < 0))
        Mnew = jnp.where(mm_ok > NEG, ext, NEG)
        Inew = jnp.where(in_win, ins, NEG)
        Dnew = jnp.where(in_win, dels, NEG)

        # completion (checked BEFORE trim, wfa.cc:122)
        mk = jnp.sum(jnp.where(at_kend & (Mnew > NEG), Mnew, 0), axis=1)
        hit = (
            jnp.any(at_kend & (Mnew > NEG), axis=1)
            & (mk >= n)
            & (mk - k_end >= m)
        )
        done_now = (final_s < 0) & hit & ~band_flag
        final_s = jnp.where(done_now, s, final_s)

        # adaptive trim (wfa.cc:127-156), skipped for just-completed rows
        width = hi_new - lo_new + 1
        need_trim = nonempty & (width > max_wf_length) & ~done_now
        prog = jnp.where(Mnew > NEG, 2 * Mnew - karr[None, :], NEG)
        best_p = jnp.max(prog, axis=1)
        best_k = jnp.min(
            jnp.where(prog == best_p[:, None], karr[None, :], 2 * L),
            axis=1,
        )
        # no valid M anywhere: the arbiter leaves best_k = w.lo
        best_k = jnp.where(best_p > NEG, best_k, lo_new)
        nlo = jnp.maximum(best_k - half, lo_new)
        nhi = jnp.minimum(best_k + half, hi_new)
        lo_f = jnp.where(need_trim, nlo, lo_new)
        hi_f = jnp.where(need_trim, nhi, hi_new)
        keep = (karr[None, :] >= lo_f[:, None]) & (
            karr[None, :] <= hi_f[:, None]
        )
        Mnew = jnp.where(keep, Mnew, NEG)
        Inew = jnp.where(keep, Inew, NEG)
        Dnew = jnp.where(keep, Dnew, NEG)
        lo_f = jnp.where(nonempty, lo_f, 1)
        hi_f = jnp.where(nonempty, hi_f, 0)

        # rows already finished earlier stay frozen (their history rows
        # beyond final_s are never read)
        sm = s % ring
        Mr = Mr.at[sm].set(Mnew)
        Ir = Ir.at[sm].set(Inew)
        Dr = Dr.at[sm].set(Dnew)
        lor = lor.at[sm].set(lo_f)
        hir = hir.at[sm].set(hi_f)
        m_hist = jax.lax.dynamic_update_slice(
            m_hist, hist_plane(Mnew)[None], (s, 0, 0)
        )
        lo_hist = jax.lax.dynamic_update_slice(
            lo_hist, lo_f.astype(jnp.int16)[None], (s, 0)
        )
        hi_hist = jax.lax.dynamic_update_slice(
            hi_hist, hi_f.astype(jnp.int16)[None], (s, 0)
        )
        return (
            s + 1, Mr, Ir, Dr, lor, hir, m_hist, lo_hist, hi_hist,
            band_flag, final_s,
        )

    def body_k(carry):
        for _ in range(K_STEPS):
            carry = body(carry)
        return carry

    carry = (
        jnp.int32(1), Mr, Ir, Dr, lor, hir, m_hist, lo_hist, hi_hist,
        band_flag, final_s,
    )
    carry = jax.lax.while_loop(cond, body_k, carry)
    (_s, _Mr, _Ir, _Dr, _lor, _hir, m_hist, lo_hist, hi_hist, band_flag,
     final_s) = carry
    return dict(
        m_hist=m_hist, lo_hist=lo_hist, hi_hist=hi_hist,
        final_s=jnp.where(band_flag, -1, final_s),
        band_overflow=band_flag,
    )


# ---------------------------------------------------------------------------
# host side: I/D reconstruction + arbiter-exact backtrace


def _rebuild_ids(m_hist, lo_hist, hi_hist, final_s, L, x, o, e):
    """Recompute the I/D wavefronts for ONE segment from its M history
    (the recurrences of wfa.cc:97-106, vectorized over diagonals)."""
    D = 2 * L
    S = final_s
    M = np.full((S + 1, D), KNULL, dtype=np.int64)
    I = np.full((S + 1, D), KNULL, dtype=np.int64)
    Dv = np.full((S + 1, D), KNULL, dtype=np.int64)
    valid = m_hist[: S + 1] >= 0
    M[valid] = m_hist[: S + 1][valid]

    def shp(v):  # value at k-1
        out = np.full(D, KNULL, dtype=np.int64)
        out[1:] = v[:-1]
        return out

    def shm(v):  # value at k+1
        out = np.full(D, KNULL, dtype=np.int64)
        out[:-1] = v[1:]
        return out

    karr = np.arange(D) - L
    for s in range(1, S + 1):
        lo, hi = int(lo_hist[s]), int(hi_hist[s])
        if lo > hi:
            continue
        in_win = (karr >= lo) & (karr <= hi)
        Moe = M[s - o - e] if s >= o + e else np.full(D, KNULL)
        Ie = I[s - e] if s >= e else np.full(D, KNULL)
        De = Dv[s - e] if s >= e else np.full(D, KNULL)
        ins = np.maximum(shp(Moe), shp(Ie))
        ins = np.where(ins > KNULL, ins + 1, KNULL)
        dels = np.maximum(shm(Moe), shm(De))
        I[s] = np.where(in_win, ins, KNULL)
        Dv[s] = np.where(in_win, dels, KNULL)
    return M, I, Dv


def _backtrace_host(t, q, M, I, Dv, final_s, L, x, o, e):
    """Port of wfa.cc:162-257 (branch-for-branch) over the numpy planes."""
    n, m = len(t), len(q)

    def g(plane, s, k):
        idx = k + L
        if idx < 0 or idx >= plane.shape[1]:
            return KNULL
        return int(plane[s, idx])

    k = n - m
    s = final_s
    off = g(M, s, k)
    state = "M"
    rt = bytearray()
    rq = bytearray()
    while True:
        if state == "M":
            from_x = KNULL
            from_i = g(I, s, k)
            from_d = g(Dv, s, k)
            if s >= x:
                v = g(M, s - x, k)
                if v > KNULL:
                    from_x = v + 1
            entry = max(from_x, from_i, from_d)
            if s == 0:
                entry = 0
            for p in range(off, entry, -1):
                rt.append(t[p - 1])
                rq.append(q[p - 1 - k])
            off = entry
            if s == 0:
                break
            if from_x == entry and from_x > KNULL:
                rt.append(t[off - 1])
                rq.append(q[off - 1 - k])
                s -= x
                off -= 1
                state = "M"
                off = g(M, s, k)
            elif from_i == entry and from_i > KNULL:
                state = "I"
            else:
                state = "D"
        elif state == "I":
            rt.append(t[off - 1])
            rq.append(ord("-"))
            from_open = g(M, s - o - e, k - 1) if s >= o + e else KNULL
            from_ext = g(I, s - e, k - 1) if s >= e else KNULL
            off -= 1
            k -= 1
            if from_ext > KNULL and from_ext == off and not (
                from_open > KNULL and from_open == off
            ):
                s -= e
                state = "I"
            elif from_open > KNULL and from_open == off:
                s -= o + e
                state = "M"
            else:
                s -= e
                state = "I"
        else:  # D
            rt.append(ord("-"))
            rq.append(q[off - k - 1])
            from_open = g(M, s - o - e, k + 1) if s >= o + e else KNULL
            from_ext = g(Dv, s - e, k + 1) if s >= e else KNULL
            k += 1
            if from_ext > KNULL and from_ext == off and not (
                from_open > KNULL and from_open == off
            ):
                s -= e
                state = "D"
            elif from_open > KNULL and from_open == off:
                s -= o + e
                state = "M"
            else:
                s -= e
                state = "D"
        if s == 0 and state == "M":
            for p in range(off, 0, -1):
                rt.append(t[p - 1])
                rq.append(q[p - 1 - k])
            break
    return bytes(reversed(rt)).decode(), bytes(reversed(rq)).decode()


def batch_wfa_align(
    pairs: Sequence[Tuple[bytes, bytes]],
    max_wf_length: int = 384,
    mismatch: int = 3,
    open_penalty: int = 3,
    ext_penalty: int = 1,
    max_steps: int = 1024,
    L: int = 512,
    S_max: int = 256,
    chunk: int = 256,
) -> List[Optional[Tuple[str, str]]]:
    """Align many (target, query) byte pairs; device forward + host
    backtrace for every segment that fits (len <= L, score <= S_max),
    native host path for the rest.  Bit-identical to wfa.cc output.

    Segments run in fixed-size device chunks of ``chunk`` (padded with
    trivial 1-base pairs): the forward kernel materializes ~4-5 MB/segment
    of wavefront state, so an unchunked genome-scale batch would exhaust device memory,
    and a traced batch dimension would recompile per distinct G (remote
    compiles on this box run 10s-6min)."""
    from ..core import wfa as host_wfa

    out: List[Optional[Tuple[str, str]]] = [None] * len(pairs)
    dev_ids = [
        i
        for i, (t, q) in enumerate(pairs)
        if len(t) <= L and len(q) <= L and len(t) > 0 and len(q) > 0
    ]
    dev_set = set(dev_ids)
    host_ids = [i for i in range(len(pairs)) if i not in dev_set]

    for c0 in range(0, len(dev_ids), chunk):
        ids = dev_ids[c0 : c0 + chunk]
        # static batch dim: bounded device memory, few compile shapes (power-of-two
        # buckets for the final partial chunk, `chunk` for full ones)
        G = chunk if len(ids) == chunk else max(8, 1 << (len(ids) - 1).bit_length())
        t_b = np.zeros((G, L), dtype=np.uint8)
        q_b = np.full((G, L), 0xFF, dtype=np.uint8)
        n = np.ones(G, dtype=np.int32)
        m = np.ones(G, dtype=np.int32)
        # pad rows beyond the real segments align trivially (score 0)
        t_b[:, 0] = ord("A")
        q_b[:, 0] = ord("A")
        for gi, i in enumerate(ids):
            t, q = pairs[i]
            t_b[gi, :] = 0
            q_b[gi, :] = 0xFF
            t_b[gi, : len(t)] = np.frombuffer(bytes(t), dtype=np.uint8)
            q_b[gi, : len(q)] = np.frombuffer(bytes(q), dtype=np.uint8)
            n[gi] = len(t)
            m[gi] = len(q)
        res = wfa_forward_batch(
            jnp.asarray(t_b), jnp.asarray(q_b),
            jnp.asarray(n), jnp.asarray(m),
            L=L, S_max=S_max, max_wf_length=max_wf_length,
            x=mismatch, o=open_penalty, e=ext_penalty,
        )
        final_s = np.asarray(res["final_s"][: len(ids)])
        # download only the scores actually reached
        smax = int(final_s.max()) if final_s.size else -1
        m_hist = np.asarray(res["m_hist"][: max(smax, 0) + 1, : len(ids)])
        lo_hist = np.asarray(res["lo_hist"][: max(smax, 0) + 1, : len(ids)])
        hi_hist = np.asarray(res["hi_hist"][: max(smax, 0) + 1, : len(ids)])
        for gi, i in enumerate(ids):
            fs = int(final_s[gi])
            if fs < 0 or fs > max_steps:
                host_ids.append(i)
                continue
            t, q = bytes(pairs[i][0]), bytes(pairs[i][1])
            M, I, Dv = _rebuild_ids(
                m_hist[:, gi], lo_hist[:, gi], hi_hist[:, gi], fs, L,
                mismatch, open_penalty, ext_penalty,
            )
            out[i] = _backtrace_host(
                t, q, M, I, Dv, fs, L, mismatch, open_penalty, ext_penalty
            )

    for i in host_ids:
        t, q = pairs[i]
        out[i] = host_wfa.wfa_align_bases(
            bytes(t).decode(), bytes(q).decode(), max_wf_length,
            mismatch, open_penalty, ext_penalty, max_steps,
        )
    return out
