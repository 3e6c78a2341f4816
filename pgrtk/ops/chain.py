"""Batched sparse anchor-chain DP scoring on device — exact reference
semantics with a bounded lookback window and a per-group exactness flag.

The reference chains anchors per (query, target) group with a serial DP
(pgr-db/src/aln.rs:12-142): anchors sorted by q_bgn; each anchor scans
predecessors from nearest to farthest and STOPS once it has examined
`max_span` DISTINCT predecessor left-coordinates (a per-anchor break over
a value set, not a fixed window).  Three quirks matter for bit-parity:

  * the DP score map is keyed by anchor VALUE, so duplicate anchors share
    one entry and later occurrences overwrite earlier ones
    (aln.rs: `v_s.insert(*hp, ...)`);
  * the nearest predecessor wins score ties (strict `>` scanning from
    nearest to farthest);
  * predecessors skipped by the orientation / max_gap / same-left filters
    do NOT count toward the `max_span` distinct-left break.

This kernel scores G groups simultaneously: one `lax.scan` walks the
anchor index while every group occupies a lane row, and each step
scores the current anchor against a rolling window of the previous W
anchors with the exact distinct-left break applied INSIDE the window
(pairwise distinct-left masks, O(W^2) per step, vectorized).  Whenever
the reference's scan would have had to look beyond the last W anchors
(window exhausted with fewer than `max_span` distinct lefts and
predecessors evicted), the group is flagged `inexact` so the caller can
fall back to the bit-exact host path (native/src/chain.cc).  Groups not
flagged are bit-identical to the reference: the scan stays within the
last W steps, and duplicate slots are overwritten on insertion so every
window occurrence of a value carries the value's latest score, exactly
like the reference's value-keyed map.

All coordinates are converted u32 -> f32 BEFORE any subtraction (the
reference's `as f32` casts round above 2^24) and the score is accumulated
in the reference's f32 op order; equality comparisons (same-left,
duplicate detection) use the integer coordinates, not the lossy floats.

Traceback (iterated best-first chain extraction, aln.rs:105-141) runs on
host from the returned score/predecessor planes, deduplicating anchors by
value (first-appearance candidate order, last-occurrence score/prev) to
mirror the reference's value-keyed maps.
"""
from __future__ import annotations

import functools
import logging
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.float32(-3.0e38)

log = logging.getLogger("pgrtk")


def _f32(v: float) -> float:
    return struct.unpack("f", struct.pack("f", v))[0]


@functools.partial(
    jax.jit,
    static_argnames=("lookback", "oriented", "max_gap", "penalty", "max_span"),
)
def chain_scores_dense(
    anchors: jnp.ndarray,
    valid: jnp.ndarray,
    penalty: float,
    max_gap: int = -1,
    oriented: bool = False,
    lookback: int = 32,
    max_span: int = 8,
):
    """Score anchors against their predecessors, reference-exactly.

    Args:
      anchors: (G, N, 6) uint32 — q_bgn, q_end, q_ori, t_bgn, t_end, t_ori,
               sorted by q_bgn within each group (stable), padded rows
               marked invalid.
      valid:   (G, N) bool
      penalty: gap penalty factor (f32)
      max_gap: max allowed gap (<0 = unbounded)
      oriented: require consistent relative orientation
      lookback: W, number of previous anchors held in the window
      max_span: the reference's distinct-left-coordinate scan bound

    Returns (scores (G, N) f32, best_prev (G, N) i32 — anchor index of the
    best predecessor or -1, inexact (G,) bool — True when some anchor's
    scan would have left the window, so the group needs the host path).
    """
    G, N, _ = anchors.shape
    ai = anchors.astype(jnp.int32)  # bit-exact equality comparisons
    af = anchors.astype(jnp.float32)
    q_bgn_f, q_end_f = af[..., 0], af[..., 1]
    self_score = q_end_f - q_bgn_f
    rel_ori = (ai[..., 2] ^ ai[..., 5]).astype(jnp.int32)
    same_ori = ai[..., 2] == ai[..., 5]

    W = lookback

    def wfull(v, dtype=jnp.float32):
        return jnp.full((G, W), v, dtype=dtype)

    init = dict(
        # f32 coords for arithmetic
        f_qe=wfull(0.0), f_tb=wfull(0.0), f_te=wfull(0.0),
        # integer coords for equality (same-left + duplicate detection)
        i_qb=wfull(-1, jnp.int32), i_qe=wfull(-1, jnp.int32),
        i_qo=wfull(-1, jnp.int32), i_tb=wfull(-1, jnp.int32),
        i_te=wfull(-1, jnp.int32), i_to=wfull(-1, jnp.int32),
        w_rel=wfull(0, jnp.int32),
        w_score=wfull(NEG),
        w_idx=wfull(-1, jnp.int32),
        inexact=jnp.zeros((G,), dtype=jnp.bool_),
    )

    slot_iota = jax.lax.broadcasted_iota(jnp.int32, (G, W), 1)

    xs = dict(
        i=jnp.arange(N, dtype=jnp.int32),
        f_qb=q_bgn_f.T, f_qe=q_end_f.T, f_tb=af[..., 3].T, f_te=af[..., 4].T,
        i_qb=ai[..., 0].T, i_qe=ai[..., 1].T, i_qo=ai[..., 2].T,
        i_tb=ai[..., 3].T, i_te=ai[..., 4].T, i_to=ai[..., 5].T,
        rel=rel_ori.T, so=same_ori.T,
        self_score=self_score.T,
        is_valid=valid.T,
    )

    def step(carry, x):
        i = x["i"]
        occupied = carry["w_idx"] >= 0  # (G, W)

        # --- predecessor filters (reference scan order: oriented, max_gap,
        # same-left; none of these count toward the distinct-left span) ---
        gap_q = jnp.abs(x["f_qb"][:, None] - carry["f_qe"])
        gap_t_same = jnp.abs(x["f_tb"][:, None] - carry["f_te"])
        gap_t_diff = jnp.abs(x["f_te"][:, None] - carry["f_tb"])
        gap_t = jnp.where(x["so"][:, None], gap_t_same, gap_t_diff)

        unfiltered = occupied
        if oriented:
            unfiltered = unfiltered & (carry["w_rel"] == x["rel"][:, None])
        if max_gap >= 0:
            mg = jnp.float32(max_gap)
            unfiltered = unfiltered & (gap_q <= mg) & (gap_t <= mg)
        same_left_cur = (
            (carry["i_qb"] == x["i_qb"][:, None])
            & (carry["i_qe"] == x["i_qe"][:, None])
            & (carry["i_qo"] == x["i_qo"][:, None])
        )
        unfiltered = unfiltered & ~same_left_cur

        # --- distinct-left break within the window ------------------------
        # A slot's left coordinate is "new" if no NEARER unfiltered slot
        # shares it (the nearest occurrence adds it to the span set).  The
        # scan processes slots in recency order and stops once the number
        # of distinct lefts reaches max_span, so a slot is scored iff the
        # distinct count among strictly nearer unfiltered slots < max_span.
        pair_same_left = (
            (carry["i_qb"][:, :, None] == carry["i_qb"][:, None, :])
            & (carry["i_qe"][:, :, None] == carry["i_qe"][:, None, :])
            & (carry["i_qo"][:, :, None] == carry["i_qo"][:, None, :])
        )  # (G, W, W): [g, a, b] lefts equal
        nearer = carry["w_idx"][:, None, :] > carry["w_idx"][:, :, None]
        unf_b = unfiltered[:, None, :]
        is_new = unfiltered & ~jnp.any(pair_same_left & nearer & unf_b, axis=2)
        n_new_nearer = jnp.sum(
            (is_new[:, None, :] & nearer).astype(jnp.int32), axis=2
        )
        scored = unfiltered & (n_new_nearer < max_span)

        # window exhausted without the break, with evicted predecessors:
        # the reference would scan past the window -> flag the group
        total_new = jnp.sum(is_new.astype(jnp.int32), axis=1)
        inexact = carry["inexact"] | (
            x["is_valid"] & (i > W) & (total_new < max_span)
        )

        # --- score (reference f32 op order, aln.rs:60-75) -----------------
        span_cur = x["self_score"][:, None]
        s1 = carry["w_score"] + span_cur
        gap = gap_q + gap_t
        # XLA contracts `s1 - penalty*gap` into an FMA (single rounding),
        # diverging from the reference's two-step f32 rounding by ~1 ulp.
        # An abs() between the mul and the sub blocks the contraction; it
        # is a numeric no-op because penalty*gap never changes sign (the
        # sign is static: gap >= 0).
        gp = jnp.abs(jnp.float32(penalty) * gap)
        if penalty < 0:
            gp = -gp
        cand = s1 - gp
        cand = jnp.where(scored, cand, NEG)
        best = cand.max(axis=1)
        # nearest predecessor wins ties (strict `>` scanning near->far):
        # among slots attaining the max, take the largest original index
        at_best = scored & (cand == best[:, None])
        best_prev_idx = jnp.max(
            jnp.where(at_best, carry["w_idx"], -1), axis=1
        )

        use_prev = best > 0.0
        score_i = jnp.where(use_prev, best, x["self_score"])
        prev_i = jnp.where(use_prev, best_prev_idx, -1)
        is_valid = x["is_valid"]
        score_i = jnp.where(is_valid, score_i, NEG)

        # --- insertion: ring slot i % W; additionally overwrite the SCORE
        # of any window duplicate of the current anchor (same 6-tuple), so
        # every occurrence of a value carries the value's latest score —
        # the reference's value-keyed v_s map (aln.rs: `v_s.insert(*hp)`).
        # Only the score is overwritten: the slot keeps its own index so
        # distinct-left counting sees each occurrence once, and the host
        # traceback canonicalizes indices by value anyway. ----------------
        at = slot_iota == (i % W)
        dup = (
            occupied & is_valid[:, None]
            & same_left_cur
            & (carry["i_tb"] == x["i_tb"][:, None])
            & (carry["i_te"] == x["i_te"][:, None])
            & (carry["i_to"] == x["i_to"][:, None])
        )

        def put(w, v):
            return jnp.where(at, v[:, None], w)

        new_idx = jnp.where(is_valid, i, -1).astype(jnp.int32)
        carry = dict(
            f_qe=put(carry["f_qe"], x["f_qe"]),
            f_tb=put(carry["f_tb"], x["f_tb"]),
            f_te=put(carry["f_te"], x["f_te"]),
            i_qb=put(carry["i_qb"], x["i_qb"]),
            i_qe=put(carry["i_qe"], x["i_qe"]),
            i_qo=put(carry["i_qo"], x["i_qo"]),
            i_tb=put(carry["i_tb"], x["i_tb"]),
            i_te=put(carry["i_te"], x["i_te"]),
            i_to=put(carry["i_to"], x["i_to"]),
            w_rel=put(carry["w_rel"], x["rel"]),
            w_score=jnp.where(at | dup, score_i[:, None], carry["w_score"]),
            w_idx=put(carry["w_idx"], new_idx),
            inexact=inexact,
        )
        return carry, (score_i, prev_i)

    final, (scores_t, prev_t) = jax.lax.scan(step, init, xs)
    return scores_t.T, prev_t.T, final["inexact"]


@functools.partial(
    jax.jit,
    static_argnames=(
        "lookback", "oriented", "max_gap", "penalty", "max_span", "unroll"
    ),
)
def chain_scores_fast(
    anchors: jnp.ndarray,
    valid: jnp.ndarray,
    penalty: float,
    max_gap: int = -1,
    oriented: bool = False,
    lookback: int = 32,
    max_span: int = 8,
    unroll: int = 4,
):
    """O(W)-per-step variant of chain_scores_dense for the common case of
    DISTINCT window lefts.

    chain_scores_dense spends O(W^2) per scan step on the pairwise
    distinct-left masks that implement the reference's value-keyed span
    break (aln.rs:29-56).  When no two window slots share a left
    coordinate — true for every anchor group without repeated query
    pairs, i.e. almost all of them — the distinct-left count equals the
    plain count of unfiltered slots, and the break reduces to "score the
    max_span most recent unfiltered predecessors": an exclusive cumsum
    over the window in recency order.

    This kernel keeps the window RECENCY-ORDERED (slot 0 = most recent;
    insertion is a static shift, not a ring write) and computes the break
    with a log2(W) doubling cumsum.

    Duplicate lefts (round 4): anchors sharing a left coordinate are
    CONSECUTIVE in every real lane — within one (query, target) group
    sorted by q_bgn, equal q_bgn means the same query pair, and a pair's
    postings expand back-to-back (aln.rs:212-226) — so same-left window
    slots form contiguous runs.  Under that invariant the distinct-left
    count is exact in O(W): a slot is "new" iff it is unfiltered and no
    NEARER slot of its run is unfiltered (with the default filters a run
    is uniformly filtered, so "new" is just run-start & unfiltered; with
    oriented/max_gap filters a short segmented OR-scan handles unevenly
    filtered runs).  The sticky per-group `dup` flag therefore only
    fires when the invariant is actually violated: a same-left window
    slot NOT contiguous with the most recent slots (possible only for
    hand-built anchor lists), or a FULL duplicate (identical 6-tuple,
    which the reference's value-keyed score map would overwrite; t
    equality is tested on the f32 coords, so coords > 2^24 may flag
    spuriously — a safe, slower direction).  Flagged groups must be
    re-run on chain_scores_dense (exact under arbitrary duplicates);
    un-flagged groups are bit-identical to it — same f32 op order, same
    FMA blocking, same nearest-wins tie-break, same window-eviction
    `inexact` condition.

    Unlike the dense kernel, INVALID anchors do not consume window slots
    (insertion is gated on validity, and the eviction condition counts
    valid anchors, not scan steps).  For chain_groups input — padding
    only after the last valid anchor — the two behaviors are identical;
    for gapped streams (the device end-to-end query path feeds rank-
    extracted pair planes with interspersed invalid slots) this keeps
    the window equal to the reference's last-W-anchors window instead of
    shrinking it by the gap density.

    Returns (scores (G, N) f32, best_prev (G, N) i32, dup (G,) bool,
    inexact (G,) bool).  `inexact` means window eviction (host fallback);
    `dup` means rerun on the dense kernel.
    """
    G, N, _ = anchors.shape
    ai = anchors.astype(jnp.int32)
    af = anchors.astype(jnp.float32)
    q_bgn_f, q_end_f = af[..., 0], af[..., 1]
    self_score = q_end_f - q_bgn_f
    rel_ori = (ai[..., 2] ^ ai[..., 5]).astype(jnp.int32)
    same_ori = ai[..., 2] == ai[..., 5]

    W = lookback

    def wfull(v, dtype=jnp.float32):
        # (W, G): W leading so the per-step shift is a static axis-0
        # slice and G is the contiguous axis
        return jnp.full((W, G), v, dtype=dtype)

    init = dict(
        w_idx=wfull(-1, jnp.int32),
        f_qe=wfull(0.0), f_tb=wfull(0.0), f_te=wfull(0.0),
        i_qb=wfull(-1, jnp.int32), i_qe=wfull(-1, jnp.int32),
        i_qo=wfull(-1, jnp.int32),
        w_rel=wfull(0, jnp.int32),
        w_score=wfull(NEG),
        nv=jnp.zeros((G,), dtype=jnp.int32),
        dup=jnp.zeros((G,), dtype=jnp.bool_),
        inexact=jnp.zeros((G,), dtype=jnp.bool_),
    )

    xs = dict(
        i=jnp.arange(N, dtype=jnp.int32),
        f_qb=q_bgn_f.T, f_qe=q_end_f.T, f_tb=af[..., 3].T, f_te=af[..., 4].T,
        i_qb=ai[..., 0].T, i_qe=ai[..., 1].T, i_qo=ai[..., 2].T,
        rel=rel_ori.T, so=same_ori.T,
        self_score=self_score.T,
        is_valid=valid.T,
    )

    def step(carry, x):
        i = x["i"]
        occ = carry["w_idx"] >= 0  # (W, G); slot d = d-th most recent valid

        gap_q = jnp.abs(x["f_qb"][None, :] - carry["f_qe"])
        gap_t_same = jnp.abs(x["f_tb"][None, :] - carry["f_te"])
        gap_t_diff = jnp.abs(x["f_te"][None, :] - carry["f_tb"])
        gap_t = jnp.where(x["so"][None, :], gap_t_same, gap_t_diff)

        unfiltered = occ
        if oriented:
            unfiltered = unfiltered & (carry["w_rel"] == x["rel"][None, :])
        if max_gap >= 0:
            mg = jnp.float32(max_gap)
            unfiltered = unfiltered & (gap_q <= mg) & (gap_t <= mg)
        same_left_cur = (
            (carry["i_qb"] == x["i_qb"][None, :])
            & (carry["i_qe"] == x["i_qe"][None, :])
            & (carry["i_qo"] == x["i_qo"][None, :])
        )
        unfiltered = unfiltered & ~same_left_cur

        # distinct-left break under the consecutive-run invariant: a slot
        # adds a NEW left iff no nearer slot of its same-left run is
        # unfiltered.  diff_prev marks run starts (slot d's left differs
        # from the nearer slot d-1's).
        diff_prev = jnp.concatenate(
            [
                jnp.ones((1, G), jnp.bool_),
                (carry["i_qb"][1:] != carry["i_qb"][:-1])
                | (carry["i_qe"][1:] != carry["i_qe"][:-1])
                | (carry["i_qo"][1:] != carry["i_qo"][:-1]),
            ],
            axis=0,
        )
        if oriented or max_gap >= 0:
            # runs may be unevenly filtered (per-slot t coords feed the
            # gap/orientation filters): segmented exclusive OR-scan of
            # `unfiltered` down the window, segments bounded by run starts
            v = jnp.concatenate(
                [jnp.zeros((1, G), jnp.bool_), unfiltered[:-1]], axis=0
            ) & ~diff_prev
            blocked = diff_prev
            sh = 1
            while sh < W:
                v = v | (
                    jnp.concatenate(
                        [jnp.zeros((sh, G), jnp.bool_), v[:-sh]], axis=0
                    )
                    & ~blocked
                )
                blocked = blocked | jnp.concatenate(
                    [jnp.ones((sh, G), jnp.bool_), blocked[:-sh]], axis=0
                )
                sh *= 2
            new = unfiltered & ~v
        else:
            # default filters depend only on the shared left -> a run is
            # uniformly filtered; its nearest member is the run start
            new = unfiltered & diff_prev

        cnt = new.astype(jnp.int32)
        sh = 1
        while sh < W:
            cnt = cnt + jnp.concatenate(
                [jnp.zeros((sh, G), jnp.int32), cnt[:-sh]], axis=0
            )
            sh *= 2
        excl = cnt - new.astype(jnp.int32)
        scored = unfiltered & (excl < max_span)

        total_new = cnt[-1]  # inclusive cumsum at the last slot
        inexact = carry["inexact"] | (
            x["is_valid"] & (carry["nv"] > W) & (total_new < max_span)
        )
        # invariant violations -> dense rerun: a same-left slot NOT in
        # the contiguous most-recent prefix (cs counts non-same-left
        # slots at or nearer than d; >0 at a same-left slot means the
        # run is broken), or a full duplicate of the current anchor
        # (same left + same t coords/orientation, f32-compared)
        slc = same_left_cur & occ
        cs = jnp.cumsum((~slc).astype(jnp.int32), axis=0)
        nonconsec = jnp.any(slc & (cs > 0), axis=0)
        fulldup = jnp.any(
            slc
            & (carry["f_tb"] == x["f_tb"][None, :])
            & (carry["f_te"] == x["f_te"][None, :])
            & (carry["w_rel"] == x["rel"][None, :]),
            axis=0,
        )
        dup = carry["dup"] | (x["is_valid"] & (nonconsec | fulldup))

        # score (identical f32 op order / FMA blocking to the dense kernel)
        span_cur = x["self_score"][None, :]
        s1 = carry["w_score"] + span_cur
        gap = gap_q + gap_t
        gp = jnp.abs(jnp.float32(penalty) * gap)
        if penalty < 0:
            gp = -gp
        cand = s1 - gp
        cand = jnp.where(scored, cand, NEG)
        best = cand.max(axis=0)
        at_best = scored & (cand == best[None, :])
        # nearest wins ties: the largest anchor index among at_best
        best_prev_idx = jnp.max(
            jnp.where(at_best, carry["w_idx"], -1), axis=0
        )

        use_prev = best > 0.0
        score_i = jnp.where(use_prev, best, x["self_score"])
        prev_i = jnp.where(use_prev, best_prev_idx, -1)
        is_valid = x["is_valid"]
        score_i = jnp.where(is_valid, score_i, NEG)

        def push(plane, v):
            # invalid anchors do not enter the window
            shifted = jnp.concatenate([v[None, :], plane[:-1]], axis=0)
            return jnp.where(is_valid[None, :], shifted, plane)

        carry = dict(
            w_idx=push(carry["w_idx"], jnp.full((G,), 1, jnp.int32) * i),
            f_qe=push(carry["f_qe"], x["f_qe"]),
            f_tb=push(carry["f_tb"], x["f_tb"]),
            f_te=push(carry["f_te"], x["f_te"]),
            i_qb=push(carry["i_qb"], x["i_qb"]),
            i_qe=push(carry["i_qe"], x["i_qe"]),
            i_qo=push(carry["i_qo"], x["i_qo"]),
            w_rel=push(carry["w_rel"], x["rel"]),
            w_score=push(carry["w_score"], score_i),
            nv=carry["nv"] + is_valid.astype(jnp.int32),
            dup=dup,
            inexact=inexact,
        )
        return carry, (score_i, prev_i)

    final, (scores_t, prev_t) = jax.lax.scan(step, init, xs, unroll=unroll)
    return scores_t.T, prev_t.T, final["dup"], final["inexact"]


@functools.partial(
    jax.jit,
    static_argnames=("lookback", "oriented", "max_gap", "penalty", "max_span"),
)
def _chain_scores_packed(
    anchors, valid, penalty, max_gap=-1, oriented=False,
    lookback=32, max_span=8,
):
    """chain_scores_dense with the three outputs packed into ONE i32
    plane (G, 2N+1): [scores bitcast | prev | inexact], so one
    device->host download replaces three."""
    scores, prev, inexact = chain_scores_dense(
        anchors, valid, penalty, max_gap, oriented,
        lookback=lookback, max_span=max_span,
    )
    return jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(scores, jnp.int32),
            prev.astype(jnp.int32),
            inexact.astype(jnp.int32)[:, None],
        ],
        axis=1,
    )


@functools.partial(
    jax.jit,
    static_argnames=("lookback", "oriented", "max_gap", "penalty", "max_span"),
)
def _fast_scores_packed(
    anchors, valid, penalty, max_gap=-1, oriented=False,
    lookback=32, max_span=8,
):
    """chain_scores_fast packed into ONE i32 plane (G, 2N+2):
    [scores bitcast | prev | dup | inexact]."""
    scores, prev, dup, inexact = chain_scores_fast(
        anchors, valid, penalty, max_gap, oriented,
        lookback=lookback, max_span=max_span,
    )
    return jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(scores, jnp.int32),
            prev.astype(jnp.int32),
            dup.astype(jnp.int32)[:, None],
            inexact.astype(jnp.int32)[:, None],
        ],
        axis=1,
    )


def traceback(
    scores: np.ndarray,
    prev: np.ndarray,
    valid: np.ndarray,
    anchors: np.ndarray,
):
    """Host traceback mirroring the reference's iterated best-first chain
    extraction over VALUE-deduplicated anchors (aln.rs:105-141): candidate
    order is first appearance in the sorted list, score/prev of a value
    come from its LAST occurrence (the reference's maps are value-keyed).

    Returns per-group [(score, [(q_triple, t_triple), ...])].
    """
    G, N = scores.shape
    out = []
    for g in range(G):
        idxs = np.flatnonzero(valid[g])
        first_of = {}
        last_of = {}
        uniq = []
        keys = [tuple(int(v) for v in anchors[g, i]) for i in range(N)]
        for i in idxs:
            k = keys[i]
            if k not in first_of:
                first_of[k] = i
                uniq.append(k)
            last_of[k] = i
        s = scores[g]
        p = prev[g]
        unvisited = set(uniq)
        chains = []
        while unvisited:
            best_s = 0.0
            best_k = None
            for k in uniq:
                if k not in unvisited:
                    continue
                sk = float(s[last_of[k]])
                if sk > best_s:
                    best_s = sk
                    best_k = k
            if best_k is None:
                break
            track = []
            k = best_k
            while k is not None and k in unvisited:
                track.append(k)
                pi = int(p[last_of[k]])
                k = keys[pi] if pi >= 0 else None
            if not track:
                break
            track.reverse()
            unvisited.difference_update(track)
            bgn_s = float(s[last_of[track[0]]])
            chains.append(
                (
                    _f32(best_s - bgn_s),
                    [((k[0], k[1], k[2]), (k[3], k[4], k[5])) for k in track],
                )
            )
        out.append(chains)
    return out


def pad_groups(groups):
    """Host helper: list of (n_i, 6) uint32 anchor arrays (pre-sorted by
    q_bgn, stable) -> (G, N, 6) padded batch + valid mask."""
    G = len(groups)
    N = max((g.shape[0] for g in groups), default=1)
    N = max(N, 1)
    anchors = np.zeros((G, N, 6), dtype=np.uint32)
    valid = np.zeros((G, N), dtype=bool)
    for i, g in enumerate(groups):
        n = g.shape[0]
        anchors[i, :n] = g
        valid[i, :n] = True
    return anchors, valid


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _stable_sorted(g) -> np.ndarray:
    g = np.ascontiguousarray(g, dtype=np.uint32)
    return g[np.argsort(g[:, 0], kind="stable")]


def chain_groups(
    groups,
    penalty: float,
    max_span: int = 8,
    max_gap=None,
    oriented: bool = False,
    lookback: int = 32,
    as_arrays: bool = False,
):
    """Chain many anchor groups on device with host fallback.

    Args:
      groups: list of (n_i, 6) uint32 arrays, UNSORTED (sorted here with a
              stable q_bgn sort, as the reference does).
    Returns: list (per group) of [(score, [HitPair, ...])], bit-identical
    to `core.aln_ref.sparse_aln`.  Groups whose scan would exceed the
    lookback window are re-run on the exact host path.

    With as_arrays=True tracks stay (m, 6) uint32 ndarrays (same rows,
    no Python tuple building — the tuple decode costs ~1.7 us/anchor and
    dominates large batches); array-aware consumers (pgr-query merge)
    produce byte-identical output from either representation.
    """
    from ..native import api as native

    if not groups:
        return []
    sizes = [g.shape[0] for g in groups]

    results = [None] * len(groups)
    # bucket by padded size to bound jit recompiles (pow2 shapes)
    buckets = {}
    for gi, n in enumerate(sizes):
        buckets.setdefault(_next_pow2(max(n, 8)), []).append(gi)
    # merge under-filled buckets upward: every device dispatch pays a
    # fixed round-trip cost, so padding a few groups to the next size is
    # taken to be cheaper than a second dispatch
    for size in sorted(buckets):
        bigger = [s for s in buckets if s > size]
        if bigger and len(buckets[size]) < 32:
            buckets[min(bigger)].extend(buckets.pop(size))

    mg = -1 if max_gap is None else int(max_gap)
    n_host = 0
    for npad, gids in buckets.items():
        # vectorized pad + batched stable q_bgn sort (the reference sorts
        # each group's anchors by q_bgn before the DP; a python per-group
        # argsort loop dominated 10k-group batches)
        nb = len(gids)
        lens_ = np.asarray([sizes[i] for i in gids], dtype=np.int64)
        flat = np.concatenate(
            [np.ascontiguousarray(groups[i], dtype=np.uint32).reshape(-1, 6)
             for i in gids]
        ) if nb else np.zeros((0, 6), np.uint32)
        offsets = np.zeros(nb + 1, dtype=np.int64)
        np.cumsum(lens_, out=offsets[1:])
        rows = np.repeat(np.arange(nb), lens_)
        cols = np.arange(offsets[-1]) - np.repeat(offsets[:-1], lens_)
        anchors = np.zeros((nb, npad, 6), dtype=np.uint32)
        valid = np.zeros((nb, npad), dtype=bool)
        anchors[rows, cols] = flat
        valid[rows, cols] = True
        qb = np.where(valid, anchors[..., 0], np.uint32(0xFFFFFFFF))
        order = np.argsort(qb, axis=1, kind="stable")
        anchors = np.take_along_axis(anchors, order[:, :, None], axis=1)
        # invalid slots (key 0xFFFFFFFF) sort last, so `valid` stays the
        # same prefix mask
        # pad the GROUP dim to a power of two as well (all-invalid rows):
        # a traced leading dim would otherwise recompile for every
        # distinct batch's group count
        pad_g = _next_pow2(anchors.shape[0]) - anchors.shape[0]
        if pad_g > 0:
            anchors = np.pad(anchors, ((0, pad_g), (0, 0), (0, 0)))
            valid = np.pad(valid, ((0, pad_g), (0, 0)))
        use_dense = os.environ.get("PGRTK_CHAIN_KERNEL", "fast") == "dense"
        if use_dense:
            packed = np.asarray(
                _chain_scores_packed(
                    jnp.asarray(anchors),
                    jnp.asarray(valid),
                    penalty,
                    mg,
                    oriented,
                    lookback=lookback,
                    max_span=max_span,
                )
            )[: len(gids)]  # ONE device->host transfer
            dup = np.zeros(len(gids), dtype=bool)
        else:
            packed = np.asarray(
                _fast_scores_packed(
                    jnp.asarray(anchors),
                    jnp.asarray(valid),
                    penalty,
                    mg,
                    oriented,
                    lookback=lookback,
                    max_span=max_span,
                )
            )[: len(gids)]  # ONE device->host transfer
            dup = packed[:, 2 * anchors.shape[1]] != 0
        anchors = anchors[: len(gids)]
        valid = valid[: len(gids)]
        n_cols = anchors.shape[1]
        scores = packed[:, :n_cols].copy().view(np.float32)
        prev = packed[:, n_cols : 2 * n_cols].copy()
        inexact = packed[:, -1] != 0
        # groups with duplicate window lefts: the fast kernel's break is
        # wrong there — rerun just those rows on the exact dense kernel
        dup_rows = np.flatnonzero(dup)
        if dup_rows.size:
            da = anchors[dup_rows]
            dv = valid[dup_rows]
            pad_g = _next_pow2(da.shape[0]) - da.shape[0]
            if pad_g > 0:
                da = np.pad(da, ((0, pad_g), (0, 0), (0, 0)))
                dv = np.pad(dv, ((0, pad_g), (0, 0)))
            dpk = np.asarray(
                _chain_scores_packed(
                    jnp.asarray(da), jnp.asarray(dv), penalty, mg, oriented,
                    lookback=lookback, max_span=max_span,
                )
            )[: dup_rows.size]
            scores[dup_rows] = np.ascontiguousarray(
                dpk[:, :n_cols]
            ).view(np.float32)
            prev[dup_rows] = dpk[:, n_cols : 2 * n_cols]
            inexact[dup_rows] = dpk[:, 2 * n_cols] != 0
        exact_rows = np.flatnonzero(~inexact)
        if native.available():
            tb = native.chain_traceback(
                anchors[exact_rows], valid[exact_rows],
                scores[exact_rows], prev[exact_rows],
                as_arrays=as_arrays,
            )
        else:
            tb = traceback(
                scores[exact_rows], prev[exact_rows], valid[exact_rows],
                anchors[exact_rows],
            )
            if as_arrays:
                tb = [
                    [
                        (s, np.asarray(
                            [[*q, *t] for q, t in track], dtype=np.uint32
                        ).reshape(-1, 6))
                        for s, track in chains
                    ]
                    for chains in tb
                ]
        for row, chains in zip(exact_rows, tb):
            results[gids[row]] = chains
        n_host += int(inexact.sum())
        for row in np.flatnonzero(inexact):
            gi = gids[row]
            chains = native.sparse_aln(
                _stable_sorted(groups[gi]), max_span, penalty, max_gap,
                oriented
            )
            if as_arrays:
                results[gi] = [
                    (float(score), np.asarray(track, dtype=np.uint32))
                    for score, track in chains
                ]
            else:
                results[gi] = [
                    (
                        score,
                        [
                            ((int(r[0]), int(r[1]), int(r[2])),
                             (int(r[3]), int(r[4]), int(r[5])))
                            for r in track
                        ],
                    )
                    for score, track in chains
                ]
    log.info(
        "chain: %d of %d groups inexact on the device, re-run on the host",
        n_host, len(groups),
    )
    return results
