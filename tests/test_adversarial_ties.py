"""Hand-derived adversarial vectors for reference tie-break behavior.

No Rust toolchain is available to run the reference (offline), so these
vectors were derived by hand-simulating the reference code paths:

  - chain DP + traceback: pgr-db/src/aln.rs:12-142
  - principal-bundle peeling: pgr-db/src/seq_db.rs:1063-1186

Each test documents the exact reference semantics it pins down.
"""
import numpy as np
import pytest

from pgrtk.core import aln_ref
from pgrtk.native import api as native


def both_impls(hits, max_span, penalty, max_gap=None, oriented=False):
    a = aln_ref.sparse_aln(list(hits), max_span, penalty, max_gap, oriented)
    flat = np.array([[*h[0], *h[1]] for h in hits], dtype=np.uint32)
    b = native.sparse_aln(flat, max_span, penalty, max_gap, oriented)
    # native must agree with the arbiter bit-for-bit
    assert len(a) == len(b)
    for (sa, ta), (sb, tb) in zip(a, b):
        assert sa == pytest.approx(sb, abs=0.0), (sa, sb)
        tb_pairs = [
            ((int(r[0]), int(r[1]), int(r[2])), (int(r[3]), int(r[4]), int(r[5])))
            for r in tb
        ]
        assert ta == tb_pairs
    return a


def test_equal_score_predecessor_tie_picks_nearest_in_scan():
    """aln.rs:87 uses strict `s > best_s` while scanning j downward from
    i-1, so among equal-score predecessors the LAST one in sorted order
    (scanned first) wins."""
    pre1 = ((0, 10, 0), (0, 10, 0))
    pre2 = ((0, 10, 0), (50, 60, 0))   # same query interval as pre1
    hp = ((20, 30, 0), (35, 45, 0))    # gap to pre1 == gap to pre2 == 35
    out = both_impls([pre1, pre2, hp], 8, 0.01)
    # pre1/pre2 cannot chain to each other (same left coordinate,
    # aln.rs:68); hp must pick pre2 (scanned first, tie not replaced)
    assert out[0][1] == [pre2, hp]
    assert out[0][0] == pytest.approx(19.65 - 10.0, abs=1e-4)
    assert out[1][1] == [pre1]
    assert out[1][0] == 0.0


def test_span_clip_counts_distinct_left_coordinates():
    """aln.rs:69-70,89-91: the lookback window counts DISTINCT pre.0
    triples and breaks AFTER evaluating the hit that fills the window —
    with max_span=1 only the nearest distinct-left predecessor is ever
    scored, even when a farther one scores higher."""
    preA = ((0, 10, 0), (0, 10, 0))
    preB = ((0, 10, 0), (200, 210, 0))
    preC = ((5, 15, 0), (5, 15, 0))
    hp = ((20, 30, 0), (20, 30, 0))
    out = both_impls([preA, preB, preC, hp], 1, 0.01)
    # preC connects to preB (nearest; scores 17.9) and the span clip
    # prevents it from ever seeing preA, which would score 19.9
    assert out[0][1] == [preB, preC, hp]
    assert out[0][0] == pytest.approx(27.8 - 10.0, abs=1e-4)
    assert out[1][1] == [preA]


def test_second_chain_cut_by_first_extraction_scores_zero():
    """aln.rs:120-140: traceback stops at already-extracted nodes, and
    the emitted score is best_s - score(track[0]), so a chain whose
    predecessor was claimed by an earlier chain reports 0.0."""
    p1 = ((0, 10, 0), (0, 10, 0))
    p2 = ((15, 25, 0), (15, 25, 0))
    t1 = ((30, 40, 0), (30, 40, 0))
    t2 = ((30, 40, 0), (100, 110, 0))  # same left coordinate as t1
    out = both_impls([p1, p2, t1, t2], 8, 0.01)
    assert out[0][1] == [p1, p2, t1]
    assert out[0][0] == pytest.approx(29.8 - 10.0, abs=1e-4)
    # t2's best predecessor is p2 (t1 skipped: same left coordinate);
    # p2 is already visited, so the track is just [t2] with score 0
    assert out[1][1] == [t2]
    assert out[1][0] == 0.0


def test_opposite_orientation_gap_uses_target_end_vs_pre_bgn():
    """aln.rs:55-57,79-83: when hp's query/target orientations differ the
    target-side gap is |hp.1.1 - pre.1.0| (end vs begin), not
    |hp.1.0 - pre.1.1|."""
    pre = ((0, 10, 0), (0, 10, 0))
    hp = ((20, 30, 0), (50, 60, 1))
    out = both_impls([pre, hp], 8, 0.01)
    # gap = |20-10| + |60-0| = 70 -> score 19.3, chain start at 10
    assert out[0][1] == [pre, hp]
    assert out[0][0] == pytest.approx(19.3 - 10.0, abs=1e-4)

    # with orientated=true the mixed-orientation link is skipped entirely
    out = both_impls([pre, hp], 8, 0.01, None, True)
    assert sorted(t for _, t in out) == sorted([[pre], [hp]])
    assert all(s == 0.0 for s, _ in out)


def test_max_gap_filter_applies_before_same_left_skip():
    """aln.rs:53-66: the max_gap filter runs before scoring; a predecessor
    just past the gap bound must not chain."""
    pre = ((0, 10, 0), (0, 10, 0))
    hp = ((120, 130, 0), (120, 130, 0))  # gaps of 110 on both sides
    out = both_impls([pre, hp], 8, 0.01, 100)
    assert sorted(t for _, t in out) == sorted([[pre], [hp]])
    out = both_impls([pre, hp], 8, 0.01, 120)
    assert out[0][1] == [pre, hp]


# ---------------------------------------------------------------------------
# principal-bundle peeling (seq_db.rs:1063-1186)
# ---------------------------------------------------------------------------

def _node(h, o):
    return (h, h, o)


def test_peeling_terminal_quirk_marks_edge_source_not_join():
    """seq_db.rs:1116-1123 inserts *v* (the edge source) into
    terminal_vertices when the edge TARGET w has in-degree > 1 — the join
    vertex itself is NOT terminal.  Graph: A->B->C->D plus X->C (C has
    in-degree 2), with skew-symmetric reverse edges.

    Hand simulation of the reference (petgraph node order = first-touch
    order; starts popped from the back; DFS breaks AT terminals;
    removing a node removes its reverse):
      terminals = {rC (out-degree 2), B, X (the quirk)}
      peel 1: start X -> [X]            (X is terminal immediately)
      peel 2: start rD -> [rD, rC]      (breaks at rC; removes D, C too)
      peel 3: start rB -> [rB, rA]
      sorted by length desc (stable): [[rD,rC], [rB,rA], [X]]
    """
    from pgrtk.graph.bundles import get_principal_bundles_from_adj_list

    A, B, C, D, X = (_node(h, 0) for h in (1, 2, 3, 4, 9))
    rA, rB, rC, rD, rX = (_node(h, 1) for h in (1, 2, 3, 4, 9))
    adj = [
        (0, A, B), (0, rB, rA),
        (0, B, C), (0, rC, rB),
        (0, C, D), (0, rD, rC),
        (1, X, C), (1, rC, rX),
    ]
    # one signature per pair-key (coverage scores for the weighted DFS)
    frag_map = {
        (h, h): [(0, 0, 0, 10, 0)] for h in (1, 2, 3, 4, 9)
    }
    bundles, filtered = get_principal_bundles_from_adj_list(frag_map, adj, 0)
    assert bundles == [[rD, rC], [rB, rA], [X]]
    assert filtered == adj


def test_peeling_pure_cycle_starts_anywhere_and_unrolls():
    """seq_db.rs:1131-1137,1177-1182: a graph with no in-degree-0 vertex
    seeds the peel from the first remaining node (insertion order)."""
    from pgrtk.graph.bundles import get_principal_bundles_from_adj_list

    A, B, C = (_node(h, 0) for h in (1, 2, 3))
    rA, rB, rC = (_node(h, 1) for h in (1, 2, 3))
    adj = [
        (0, A, B), (0, rB, rA),
        (0, B, C), (0, rC, rB),
        (0, C, A), (0, rA, rC),
    ]
    frag_map = {(h, h): [(0, 0, 0, 10, 0)] for h in (1, 2, 3)}
    bundles, _ = get_principal_bundles_from_adj_list(frag_map, adj, 0)
    # no terminals (every vertex has out/in degree 1 in each direction);
    # the forward cycle unrolls from A, which removes the reverse cycle
    assert bundles == [[A, B, C]]


# ---------------------------------------------------------------------------
# Bundle order/direction consensus vote (ext.rs:601-625).
# Hand-derivations below simulate the Rust loop exactly:
#   let sum: f32 = orders.iter().sum();           // f32 accumulation
#   let mean_ord = (sum / len as f32) as usize;   // f32 divide, TRUNCATE
#   direction = if dir_sum < (len >> 1) { 0 } else { 1 }
#   unvisited -> (usize::MAX, bid, 0); Vec::sort() on the tuples
# ---------------------------------------------------------------------------


def test_bundle_vote_direction_is_not_majority():
    """dir_sum < (len >> 1) is NOT a majority vote: 2 reverse votes of 5
    give direction 1 (2 < 2 is false), and an exact half (2 of 4) also
    gives 1; only strictly-below-half-floor gives 0."""
    from pgrtk.api import consensus_bundle_order_direction

    out = consensus_bundle_order_direction(
        {0: [0.0], 1: [0.0], 2: [0.0], 3: [0.0]},
        {
            0: [1, 1, 0, 0, 0],  # 2/5 reverse -> 2 < (5>>1)=2 false -> 1
            1: [1, 0, 0, 0, 0],  # 1/5 reverse -> 1 < 2 -> 0
            2: [1, 1, 0, 0],     # 2/4 reverse -> 2 < 2 false -> 1
            3: [1, 0, 0, 0],     # 1/4 reverse -> 1 < 2 -> 0
        },
        4,
    )
    assert [(bid, d) for _o, bid, d in out] == [
        (0, 1), (1, 0), (2, 1), (3, 0)
    ]


def test_bundle_vote_mean_truncates_and_ties_sort_by_bid():
    """(sum/len) as usize truncates (1.5 -> 1); equal means sort by bid
    ascending (tuple sort on (mean_ord, bid, direction))."""
    from pgrtk.api import consensus_bundle_order_direction

    out = consensus_bundle_order_direction(
        {0: [1.0, 2.0], 1: [1.0], 2: [1.9]},
        # NB [0] alone would still vote direction 1 (0 < (1>>1)=0 false);
        # three forward votes give 0 < 1 -> direction 0
        {0: [0, 0, 0], 1: [0, 0, 0], 2: [0, 0, 0]},
        3,
    )
    # bundle 0: mean 1.5 -> 1; bundle 1: 1.0 -> 1; bundle 2: 1.9 -> 1
    assert out == [(1, 0, 0), (1, 1, 0), (1, 2, 0)]


def test_bundle_vote_unvisited_sorts_last_with_direction_zero():
    """Bundles never seen by any sequence get order usize::MAX and
    direction 0, after every visited bundle (ext.rs:618-621)."""
    from pgrtk.api import consensus_bundle_order_direction

    out = consensus_bundle_order_direction(
        {1: [5.0]}, {1: [1]}, 3
    )
    assert out[0] == (5, 1, 1)  # dir: 1 < (1>>1)=0 false -> 1
    assert out[1][1:] == (0, 0) and out[2][1:] == (2, 0)
    assert out[1][0] == out[2][0] > 10**9  # usize::MAX stand-in


def test_bundle_vote_f32_sum_rounding_shifts_truncated_mean():
    """The reference sums orders in f32: [3, 2^24] accumulates to
    16777220.0f32 (16777219 is not representable; ties round to even
    mantissa), so the truncated mean is 8388610 — a f64 sum would give
    trunc(8388609.5) = 8388609.  Pins the f32 accumulation order."""
    from pgrtk.api import consensus_bundle_order_direction

    out = consensus_bundle_order_direction(
        {0: [3.0, 16777216.0]}, {0: [0, 0, 0]}, 1
    )
    assert out == [(8388610, 0, 0)]


# ---------------------------------------------------------------------------
# pgr-query orientation vote + region merge (pgr-query.rs:168-285).
# Vectors call cli.pgr_query.merge_regions_for_query directly with
# hand-built (sid, [(score, [HitPair,...])]) inputs.
# ---------------------------------------------------------------------------


def _hp(qb, qe, qo, tb, te, to):
    return ((qb, qe, qo), (tb, te, to))


def test_query_vote_accumulates_across_chains_of_one_target():
    """pgr-query.rs:171-186 declares f_count/r_count per TARGET and votes
    per chain AFTER adding that chain's counts: a 3-anchor all-reverse
    chain following a 4-anchor all-forward chain sees f=4, r=3 and is
    assigned orientation 0, though alone it would vote 1."""
    from pgrtk.cli.pgr_query import merge_regions_for_query

    fwd = [_hp(0, 10, 0, 100, 110, 0), _hp(20, 30, 0, 120, 130, 0),
           _hp(40, 50, 0, 140, 150, 0), _hp(60, 70, 0, 160, 170, 0)]
    rev = [_hp(0, 10, 0, 500000, 500010, 1),
           _hp(20, 30, 0, 499980, 499990, 1),
           _hp(40, 50, 0, 499960, 499970, 1)]
    regions = merge_regions_for_query([(7, [(4.0, fwd), (3.0, rev)])], 1000)
    # both chains carry orientation 0 -> both in the forward merge list;
    # ranges (100,170) and (499960,500010) are > tol apart -> two regions
    assert [(b, e, o) for b, e, _l, o, _a in regions[7]] == [
        (100, 170, 0), (499960, 500010, 0)
    ]


def test_query_vote_ignores_two_anchor_chains_entirely():
    """Chains with len <= 2 are skipped BEFORE counting (aln.len() > 2
    guards the whole block): a 2-anchor reverse chain contributes nothing,
    so a following chain with f=2, r=1 votes 0 (2 > 1)."""
    from pgrtk.cli.pgr_query import merge_regions_for_query

    two_rev = [_hp(0, 10, 0, 900, 910, 1), _hp(20, 30, 0, 880, 890, 1)]
    mixed = [_hp(0, 10, 0, 100, 110, 0), _hp(20, 30, 0, 120, 130, 0),
             _hp(40, 50, 0, 140, 150, 1)]
    regions = merge_regions_for_query(
        [(3, [(2.0, two_rev), (2.5, mixed)])], 1000
    )
    assert len(regions[3]) == 1
    b, e, _l, o, _a = regions[3][0]
    assert (b, e, o) == (100, 150, 0)  # ori 0, two_rev never counted


def test_query_region_end_from_lex_largest_pair_not_max_end():
    """pgr-query.rs:193-199: target (bgn, end) pairs are tuple-sorted and
    the region end is the LAST pair's end — (10, 20) outranks (5, 100),
    so the region is (5, 20), not (5, 100)."""
    from pgrtk.cli.pgr_query import merge_regions_for_query

    aln = [_hp(0, 10, 0, 5, 100, 0), _hp(20, 30, 0, 10, 20, 0),
           _hp(40, 50, 0, 10, 15, 0)]
    regions = merge_regions_for_query([(1, [(3.0, aln)])], 1000)
    b, e, ln, o, _a = regions[1][0]
    assert (b, e, ln, o) == (5, 20, 15, 0)


def test_query_merge_contained_region_keeps_long_end():
    """Merging a region contained in the previous one keeps the longer
    end (end = max(r_end, l_end), pgr-query.rs:235-236), and overlap
    (negative gap) always merges (i64 compare < tol)."""
    from pgrtk.cli.pgr_query import merge_regions_for_query

    big = [_hp(0, 10, 0, 0, 20000, 0), _hp(20, 30, 0, 25000, 30000, 0),
           _hp(40, 50, 0, 45000, 50000, 0)]
    small = [_hp(60, 70, 0, 10, 40, 0), _hp(80, 90, 0, 50, 70, 0),
             _hp(95, 99, 0, 80, 100, 0)]
    regions = merge_regions_for_query(
        [(2, [(9.0, big), (1.0, small)])], 1000
    )
    assert [(b, e) for b, e, _l, _o, _a in regions[2]] == [(0, 50000)]


def test_query_merge_tol_is_strict_and_orientations_split():
    """gap == merge_range_tol does NOT merge (strict <); gap == tol-1
    does; opposite-orientation regions never merge even when adjacent
    (separate f/r merge passes, forward regions emitted first)."""
    from pgrtk.cli.pgr_query import merge_regions_for_query

    a = [_hp(0, 10, 0, 0, 100, 0), _hp(20, 30, 0, 40, 60, 0),
         _hp(40, 50, 0, 70, 100, 0)]
    b = [_hp(0, 10, 0, 1100, 1200, 0), _hp(20, 30, 0, 1140, 1160, 0),
         _hp(40, 50, 0, 1170, 1200, 0)]
    # gap = 1100 - 100 = 1000
    exact = merge_regions_for_query([(4, [(3.0, a), (3.0, b)])], 1000)
    assert [(x[0], x[1]) for x in exact[4]] == [(0, 100), (1100, 1200)]
    under = merge_regions_for_query([(4, [(3.0, a), (3.0, b)])], 1001)
    assert [(x[0], x[1]) for x in under[4]] == [(0, 1200)]

    r = [_hp(0, 10, 0, 150, 250, 1), _hp(20, 30, 0, 180, 200, 1),
         _hp(40, 50, 0, 210, 250, 1)]
    both = merge_regions_for_query([(4, [(3.0, a), (3.0, r)])], 100000)
    assert [(x[0], x[1], x[3]) for x in both[4]] == [
        (0, 100, 0), (150, 250, 1)
    ]
