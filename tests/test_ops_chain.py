"""Device chain-DP scorer vs the exact scalar reference (aln_ref).

The device kernel (ops/chain.py) claims BIT-exact parity with the
reference DP (pgr-db/src/aln.rs:12-142) for every group it does not flag
`inexact`; `chain_groups` falls back to the native host path for flagged
groups.  These tests assert bit-for-bit equality of chain partitions AND
f32 scores — no tolerances.
"""
import os

import numpy as np
import pytest

from pgrtk.core import aln_ref


def _load_hits(test_data_dir, n=400):
    hits = []
    with open(os.path.join(test_data_dir, "test_hits")) as f:
        for line in f:
            v = [int(t) for t in line.split()]
            hits.append(((v[0], v[1], v[2]), (v[3], v[4], v[5])))
            if len(hits) >= n:
                break
    return hits


def _as_arr(hits):
    return np.asarray([[*a, *b] for a, b in hits], dtype=np.uint32)


def _assert_chains_equal(got, ref):
    assert len(got) == len(ref)
    for (ds, dtrack), (rs, rtrack) in zip(got, ref):
        assert ds == rs, (ds, rs)
        assert dtrack == rtrack


def test_chain_groups_bit_exact_production_span(test_data_dir):
    """max_span=8 (the production default) + W=32 window; inexact groups
    transparently fall back, so results are always bit-exact."""
    from pgrtk.ops import chain as dchain

    hits = _load_hits(test_data_dir, 400)
    groups = [_as_arr(hits[:64]), _as_arr(hits[64:256]), _as_arr(hits[256:])]
    refs = [
        aln_ref.sparse_aln(
            [((int(r[0]), int(r[1]), int(r[2])),
              (int(r[3]), int(r[4]), int(r[5]))) for r in g],
            8, 0.025, None, False,
        )
        for g in groups
    ]
    outs = dchain.chain_groups(groups, 0.025, max_span=8, lookback=32)
    for got, ref in zip(outs, refs):
        _assert_chains_equal(got, ref)


def test_chain_groups_oriented_and_gap(test_data_dir):
    from pgrtk.ops import chain as dchain

    hits = _load_hits(test_data_dir, 256)
    arr = _as_arr(hits)
    for oriented, max_gap, span in (
        (True, None, 8), (False, 1000, 8), (True, 1000, 4), (False, None, 1)
    ):
        ref = aln_ref.sparse_aln(list(hits), span, 0.5, max_gap, oriented)
        out = dchain.chain_groups(
            [arr], 0.5, max_span=span, max_gap=max_gap, oriented=oriented,
            lookback=32,
        )[0]
        _assert_chains_equal(out, ref)


def test_kernel_exact_when_window_covers_group(test_data_dir):
    """With W >= group size nothing can be flagged inexact and the raw
    kernel output itself must be bit-exact (unbounded effective span)."""
    import jax.numpy as jnp

    from pgrtk.ops import chain as dchain

    hits = _load_hits(test_data_dir, 256)
    hits_sorted = sorted(hits, key=lambda h: h[0][0])
    ref = aln_ref.sparse_aln(list(hits), 10**9, 0.5, None, False)
    arr = _as_arr(hits_sorted)
    anchors, valid = dchain.pad_groups([arr])
    scores, prev, inexact = dchain.chain_scores_dense(
        jnp.asarray(anchors), jnp.asarray(valid), 0.5, -1, False,
        lookback=256, max_span=10**6,
    )
    assert not bool(np.asarray(inexact)[0])
    chains = dchain.traceback(
        np.asarray(scores), np.asarray(prev), valid, anchors
    )[0]
    _assert_chains_equal(chains, ref)


def test_adversarial_vectors_through_device_kernel():
    """The hand-derived tie-break vectors (test_adversarial_ties.py) must
    hold through the device scorer too: nearest-wins ties, distinct-left
    span clip, duplicate-anchor value semantics."""
    from pgrtk.ops import chain as dchain

    cases = [
        # (hits, max_span)
        ([((0, 10, 0), (0, 10, 0)), ((0, 10, 0), (50, 60, 0)),
          ((20, 30, 0), (35, 45, 0))], 8),
        ([((0, 10, 0), (0, 10, 0)), ((0, 10, 0), (200, 210, 0)),
          ((5, 15, 0), (5, 15, 0)), ((20, 30, 0), (20, 30, 0))], 1),
        ([((0, 10, 0), (0, 10, 0)), ((15, 25, 0), (15, 25, 0)),
          ((30, 40, 0), (30, 40, 0)), ((30, 40, 0), (100, 110, 0))], 8),
        # exact duplicate anchors: value-keyed DP (v_s overwrite)
        ([((0, 10, 0), (0, 10, 0)), ((0, 10, 0), (0, 10, 0)),
          ((15, 25, 0), (15, 25, 0)), ((15, 25, 0), (15, 25, 0)),
          ((30, 40, 0), (30, 40, 0))], 8),
        ([((0, 10, 0), (5, 15, 0)), ((2, 12, 1), (5, 15, 0)),
          ((0, 10, 0), (5, 15, 0)), ((20, 30, 0), (25, 35, 0)),
          ((20, 30, 0), (25, 35, 0)), ((40, 50, 1), (45, 55, 0))], 2),
    ]
    for hits, span in cases:
        ref = aln_ref.sparse_aln(list(hits), span, 0.01, None, False)
        out = dchain.chain_groups(
            [_as_arr(hits)], 0.01, max_span=span, lookback=32
        )[0]
        _assert_chains_equal(out, ref)


def test_randomized_bit_parity_with_duplicates():
    """Randomized stress: clustered anchors with many repeated left
    coordinates and exact duplicates, all four option combinations."""
    from pgrtk.ops import chain as dchain

    rng = np.random.RandomState(7)
    for trial in range(8):
        n = int(rng.randint(8, 120))
        # trials 6-7 use large coordinates: catches FMA contraction in the
        # score (1-ulp drift at |s| ~ 1e2-1e3) and f32 coordinate rounding
        span_lo = 0 if trial < 6 else 1 << 24
        base = span_lo + rng.randint(0, 500 if trial < 6 else 40_000, size=n)
        hits = []
        for b in base:
            qb = int(b)
            qe = qb + int(rng.randint(5, 30))
            qo = int(rng.randint(0, 2))
            tb = span_lo + int(rng.randint(0, 500 if trial < 6 else 40_000))
            te = tb + int(rng.randint(5, 30))
            to = int(rng.randint(0, 2))
            hits.append(((qb, qe, qo), (tb, te, to)))
            if rng.rand() < 0.3:  # exact duplicate
                hits.append(((qb, qe, qo), (tb, te, to)))
            if rng.rand() < 0.3:  # same left, different right
                hits.append(((qb, qe, qo), (te, te + 11, to)))
        oriented = bool(trial % 2)
        max_gap = None if trial < 3 else 120
        span = [1, 2, 8][trial % 3]
        ref = aln_ref.sparse_aln(list(hits), span, 0.025, max_gap, oriented)
        out = dchain.chain_groups(
            [_as_arr(hits)], 0.025, max_span=span, max_gap=max_gap,
            oriented=oriented, lookback=32,
        )[0]
        _assert_chains_equal(out, ref)


def test_native_traceback_matches_python_traceback():
    """native.chain_traceback (chain_tb.cc) must reproduce the Python
    traceback exactly on a padded multi-group batch with duplicates and
    invalid (padding) rows — same value-dedup candidate order, same
    nearest-wins walk, same f32 chain score."""
    import jax.numpy as jnp

    from pgrtk.native import api as native
    from pgrtk.ops import chain as dchain

    if not native.available():
        import pytest

        pytest.skip("native lib unavailable")

    rng = np.random.RandomState(11)
    groups = []
    for _ in range(6):
        n = int(rng.randint(3, 40))
        hits = []
        for _ in range(n):
            qb = int(rng.randint(0, 300))
            qe = qb + int(rng.randint(5, 25))
            tb = int(rng.randint(0, 300))
            hits.append(((qb, qe, 0), (tb, tb + qe - qb, 0)))
            if rng.rand() < 0.4:
                hits.append(hits[-1])  # exact duplicate
        arr = _as_arr(hits)
        groups.append(arr[np.argsort(arr[:, 0], kind="stable")])
    anchors, valid = dchain.pad_groups(groups)
    scores, prev, _ = dchain.chain_scores_dense(
        jnp.asarray(anchors), jnp.asarray(valid), 0.025, -1, False,
        lookback=64, max_span=8,
    )
    scores = np.asarray(scores)
    prev = np.asarray(prev)
    py = dchain.traceback(scores, prev, valid, anchors)
    cc = native.chain_traceback(anchors, valid, scores, prev)
    assert len(py) == len(cc)
    for a, b in zip(py, cc):
        assert len(a) == len(b)
        for (sa, ta), (sb, tbk) in zip(a, b):
            assert np.float32(sa) == np.float32(sb)
            assert ta == tbk


def test_fast_kernel_bit_matches_dense_and_flags_duplicates():
    """chain_scores_fast must be bit-identical to chain_scores_dense on
    every group whose same-left anchors form CONSECUTIVE runs (the only
    pattern real postings expansion produces), flag `dup` only on full
    duplicates or non-consecutive same-left anchors, and agree on the
    window-eviction `inexact` flag."""
    import jax.numpy as jnp

    from pgrtk.ops import chain as dchain

    rng = np.random.RandomState(42)
    G, N = 16, 256
    groups = []
    for g in range(G):
        n = int(rng.randint(20, N))
        q = np.sort(rng.randint(0, 100000, n)).astype(np.uint32)
        anchors = np.stack(
            [
                q,
                q + rng.randint(50, 500, n).astype(np.uint32),
                rng.randint(0, 2, n).astype(np.uint32),
                rng.randint(0, 100000, n).astype(np.uint32),
                rng.randint(0, 100000, n).astype(np.uint32),
                rng.randint(0, 2, n).astype(np.uint32),
            ],
            axis=1,
        )
        if g % 4 == 0 and n > 10:
            # CONSECUTIVE same-left run (multiplicity-2 posting):
            # handled exactly, must NOT flag
            anchors[5, :3] = anchors[4, :3]
        if g % 4 == 1 and n > 10:
            # full duplicate (same 6-tuple): value-keyed score
            # overwrite -> must flag
            anchors[5] = anchors[4]
        if g % 4 == 2 and n > 10:
            # NON-consecutive same-left (hand-built pattern: same q_bgn,
            # different q_end between) -> must flag
            anchors[6, 0] = anchors[4, 0]
            anchors[5, 0] = anchors[4, 0]
            anchors[6, 1:3] = anchors[4, 1:3]
            anchors[5, 1] = anchors[4, 1] + 7
        groups.append(anchors)
    anchors, valid = dchain.pad_groups(groups)
    pad = N - anchors.shape[1]
    anchors = np.pad(anchors, ((0, 0), (0, pad), (0, 0)))
    valid = np.pad(valid, ((0, 0), (0, pad)))

    for mg, ori, pen in [(-1, False, 0.025), (10000, True, 0.5)]:
        sd, pd, ix_d = dchain.chain_scores_dense(
            jnp.asarray(anchors), jnp.asarray(valid), pen, mg, ori
        )
        sf, pf, dup, ix_f = dchain.chain_scores_fast(
            jnp.asarray(anchors), jnp.asarray(valid), pen, mg, ori
        )
        sd, pd, ix_d = map(np.asarray, (sd, pd, ix_d))
        sf, pf, dup, ix_f = map(np.asarray, (sf, pf, dup, ix_f))
        assert not dup[0] and not dup[4] and not dup[8] and not dup[12]
        assert dup[1] and dup[5] and dup[9] and dup[13]  # full dups
        assert dup[2] and dup[6] and dup[10] and dup[14]  # non-consecutive
        ok = ~dup
        assert np.array_equal(ix_d[ok], ix_f[ok])
        exact = ok & ~ix_f
        if mg == -1:  # the unfiltered config must keep some exact rows
            assert exact.any()
            # the consecutive-run groups themselves must be exact
            assert exact[0] and exact[4]
        # invalid (padding) positions carry meaningless scores/prev —
        # the traceback never visits them; compare valid positions only
        vm = valid[exact]
        assert np.array_equal(sd[exact][vm], sf[exact][vm])
        assert np.array_equal(pd[exact][vm], pf[exact][vm])


def test_fast_kernel_exact_on_multiplicity_runs():
    """Posting-multiplicity anchor pattern: runs of 2-4 same-left anchors
    (one query pair -> several target fragments), every option combo.
    The fast kernel must stay un-flagged and bit-match the dense kernel
    AND the scalar arbiter through chain_groups."""
    import jax.numpy as jnp

    from pgrtk.ops import chain as dchain

    rng = np.random.RandomState(3)
    for trial in range(6):
        hits = []
        qb = 0
        while len(hits) < 60:
            qb += int(rng.randint(20, 120))
            qe = qb + int(rng.randint(10, 60))
            qo = int(rng.randint(0, 2))
            mult = int(rng.randint(1, 5))
            for _ in range(mult):
                tb = int(rng.randint(0, 40000))
                te = tb + int(rng.randint(10, 60))
                hits.append(((qb, qe, qo), (tb, te, int(rng.randint(0, 2)))))
        arr = _as_arr(hits)
        oriented = bool(trial % 2)
        max_gap = None if trial < 3 else 5000
        span = [1, 2, 8][trial % 3]
        mg = -1 if max_gap is None else max_gap

        anchors, valid = dchain.pad_groups([arr])
        sf, pf, dup, ix_f = dchain.chain_scores_fast(
            jnp.asarray(anchors), jnp.asarray(valid), 0.025, mg, oriented,
            lookback=32, max_span=span,
        )
        assert not bool(np.asarray(dup)[0]), (trial, "spurious dup flag")
        if not bool(np.asarray(ix_f)[0]):
            sd, pd, _ = dchain.chain_scores_dense(
                jnp.asarray(anchors), jnp.asarray(valid), 0.025, mg,
                oriented, lookback=32, max_span=span,
            )
            assert np.array_equal(np.asarray(sf)[valid], np.asarray(sd)[valid])
            assert np.array_equal(np.asarray(pf)[valid], np.asarray(pd)[valid])

        ref = aln_ref.sparse_aln(list(hits), span, 0.025, max_gap, oriented)
        out = dchain.chain_groups(
            [arr], 0.025, max_span=span, max_gap=max_gap, oriented=oriented,
            lookback=32,
        )[0]
        _assert_chains_equal(out, ref)


def test_chain_groups_fast_vs_dense_kernel_env(test_data_dir, monkeypatch):
    """chain_groups output must be identical whichever device kernel
    serves it (fast is the default; dense is forced via env)."""
    from pgrtk.ops import chain as dchain

    rng = np.random.RandomState(7)
    groups = []
    for _ in range(12):
        n = int(rng.randint(3, 60))
        qb = np.sort(rng.randint(0, 5000, n)).astype(np.uint32)
        g = np.stack(
            [
                qb,
                qb + rng.randint(10, 200, n).astype(np.uint32),
                rng.randint(0, 2, n).astype(np.uint32),
                rng.randint(0, 5000, n).astype(np.uint32),
                rng.randint(0, 5000, n).astype(np.uint32),
                rng.randint(0, 2, n).astype(np.uint32),
            ],
            axis=1,
        )
        if n > 6:
            g[3] = g[2]  # full duplicate anchor
        groups.append(g)
    monkeypatch.setenv("PGRTK_CHAIN_KERNEL", "fast")
    fast = dchain.chain_groups(groups, 0.025)
    monkeypatch.setenv("PGRTK_CHAIN_KERNEL", "dense")
    dense = dchain.chain_groups(groups, 0.025)
    assert fast == dense
