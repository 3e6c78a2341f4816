"""Device end-to-end query pipeline (ops/query_e2e.py) vs the host
pipeline (core/query.py) on synthetic mini-pangenomes.

The device path runs sketch -> pair -> probe -> postings expansion ->
count filters -> chain DP inside one traceable function; the host path
is the parity-tested reference implementation of seq_db.rs:1198-1257 +
aln.rs:147-242.  Round 4 generalized the postings layout: rows carry
the target sid AS DATA with arbitrary per-(key, sid) multiplicity, so
these tests cover repeat-containing corpora (tandem duplications ->
mult > 1), target counts up to 64, live count filters, and the
truncation/overflow flag contracts.  Chains must match exactly (scores
bit-equal, tracks tuple-equal) for every (query, target) group.
"""
import numpy as np
import pytest

BASES = b"ACGT"


def _to_bytes(arr2bit):
    return bytes(bytearray(BASES[b] for b in arr2bit))


def _mutate(base, rate, rng):
    out = base.copy()
    n = rng.binomial(len(base), rate)
    pos = rng.choice(len(base), size=n, replace=False)
    out[pos] = (out[pos] + rng.integers(1, 4, size=n)) % 4
    return out


def _tandem(base, bgn, end, copies):
    """Insert (copies-1) extra adjacent copies of base[bgn:end]."""
    return np.concatenate(
        [base[:end]] + [base[bgn:end]] * (copies - 1) + [base[end:]]
    )


def _run_step(idx, queries, **kw):
    import jax
    import jax.numpy as jnp

    from pgrtk.ops import query_e2e

    B, L = queries.shape
    pad = (-L) % 512
    padded = np.pad(queries, ((0, 0), (0, pad)))
    probe = idx["probe"]
    res = jax.jit(
        query_e2e.query_e2e_step,
        static_argnames=(
            "probe_bits", "C", "P", "M", "slots2", "max_count",
            "max_count_query", "max_count_target", "lookback", "unroll",
            "max_span", "slots3", "sketch_compact", "probe_aligned",
        ),
    )(
        jnp.asarray(padded),
        jnp.full((B,), L, jnp.int32),
        probe["bits"],
        [jnp.asarray(probe["planes"][i]) for i in range(4)],
        jnp.asarray(probe["fence"]),
        jnp.asarray(idx["p_rows"]),
        idx["C"],
        P=idx["P"],
        probe_aligned=probe.get("aligned", False),
        **kw,
    )
    return {k: np.asarray(v) for k, v in res.items()}


def _host_raw(idx, q2bit):
    from pgrtk.core import query as query_mod
    from pgrtk.core.spec import ShmmrSpec

    lookup = idx["lookup"]
    spec = ShmmrSpec(80, 56, 4, 64, True)
    return query_mod.raw_query_fragment(
        lambda s0, s1: lookup.get((s0, s1), []), _to_bytes(q2bit), spec
    )


def _assert_anchor_parity(idx, queries, res, C, **filter_kw):
    from pgrtk.core import query as query_mod

    B = len(queries)  # (B, L) array or list of ragged 2-bit rows
    anchors, gvalid = res["anchors"], res["gvalid"]
    n_total = 0
    for b in range(B):
        th = query_mod.collect_target_hits(
            _host_raw(idx, queries[b]), **filter_kw
        )
        for c in range(C):
            g = b * C + c
            dev = [tuple(int(v) for v in row)
                   for row in anchors[g][gvalid[g]]]
            host = [(*lft, *t) for lft, t in th.get(c, [])]
            assert dev == host, f"anchor mismatch b={b} sid={c}"
            n_total += len(host)
    return n_total


@pytest.fixture(scope="module")
def synth():
    """Repeat-containing corpus: a 1.5-kb block tandem-TRIPLED in every
    target (per-(key,sid) multiplicity 3 inside the block) and DOUBLED
    in the queries (in-query duplicate pairs -> run_len 2)."""
    from pgrtk.ops import query_e2e

    rng = np.random.default_rng(3)
    L, T, B = 16384, 4, 2
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    targets = np.stack(
        [_tandem(_mutate(base, 2e-4, rng), 6000, 7500, 3) for _ in range(T)]
    )
    queries = np.stack(
        [_tandem(_mutate(base, 2e-4, rng), 6000, 7500, 2) for _ in range(B)]
    )
    idx = query_e2e.build_index(targets, n_decoys=2000, seed=11)
    assert idx["n_multi"] > 0  # tandem copies -> real multiplicity
    assert idx["n_truncated"] == 0
    return dict(idx=idx, targets=targets, queries=queries, B=B)


def test_device_e2e_query_matches_host_pipeline(synth):
    from pgrtk.core import query as query_mod
    from pgrtk.ops import chain as chain_ops

    idx = synth["idx"]
    queries = synth["queries"]
    B, C = synth["B"], idx["C"]

    res = _run_step(idx, queries, M=4)
    assert not bool(res["overflow"])
    assert not res["row_ovf"].any()
    assert not res["mult_ovf"].any()
    assert not res["dup"].any() and not res["inexact"].any()

    dev_chains = chain_ops.traceback(
        res["scores"], res["prev"], res["gvalid"], res["anchors"]
    )
    gvalid = res["gvalid"]
    n_groups_checked = 0
    for b in range(B):
        host = dict(
            query_mod.query_fragment_to_hps(_host_raw(idx, queries[b]), 0.025)
        )
        for c in range(C):
            g = b * C + c
            n_anchors = int(gvalid[g].sum())
            if n_anchors <= 1:
                assert c not in host, f"device lost anchors b={b} sid={c}"
                continue
            assert c in host, f"host missing group b={b} sid={c}"
            hchains = host[c]
            dchains = dev_chains[g]
            assert len(hchains) == len(dchains)
            for (hs, htrack), (ds, dtrack) in zip(hchains, dchains):
                assert np.float32(hs) == np.float32(ds)
                assert htrack == dtrack
            n_groups_checked += 1
    assert n_groups_checked == B * C  # every group had real chains


def test_anchor_sets_match_host_collect(synth):
    """The device (query, target) anchor lanes must equal the host
    count-filtered per-target hit lists — including the multiplicity-3
    postings of the tandem block, in reference order."""
    idx = synth["idx"]
    queries = synth["queries"]
    res = _run_step(idx, queries, M=4)
    n = _assert_anchor_parity(idx, queries, res, idx["C"])
    assert n > 0


def test_target_count_filter_fires_and_matches(synth):
    """run_len * mult exceeds a small max_count_target inside the tandem
    block (queries carry the key twice, targets three times -> count 6):
    the device must drop exactly the hits the host drops."""
    from pgrtk.core import query as query_mod

    idx = synth["idx"]
    queries = synth["queries"]
    C = idx["C"]

    res_def = _run_step(idx, queries, M=4)
    res_f = _run_step(idx, queries, M=4, max_count_target=4)
    _assert_anchor_parity(
        idx, queries, res_f, C, max_count_target=4
    )
    # the filter actually bound
    assert res_f["gvalid"].sum() < res_def["gvalid"].sum()
    # and the host agrees it bound
    th_all = query_mod.collect_target_hits(_host_raw(idx, queries[0]))
    th_f = query_mod.collect_target_hits(
        _host_raw(idx, queries[0]), max_count_target=4
    )
    assert sum(map(len, th_f.values())) < sum(map(len, th_all.values()))


def test_query_count_filter_fires_and_matches(synth):
    """max_count=1 drops every duplicated pair of the query's doubled
    block (aln.rs:203-211), exactly as the host does."""
    idx = synth["idx"]
    queries = synth["queries"]
    res = _run_step(idx, queries, M=4, max_count=1)
    _assert_anchor_parity(idx, queries, res, idx["C"], max_count=1)
    res_def = _run_step(idx, queries, M=4)
    assert res["gvalid"].sum() < res_def["gvalid"].sum()


def test_mult_cap_flags_groups(synth):
    """M=1 cannot place the multiplicity-3 postings: the affected
    (query, target) groups must raise mult_ovf (host-fallback contract)
    while untouched groups still match the host exactly."""
    from pgrtk.core import query as query_mod

    idx = synth["idx"]
    queries = synth["queries"]
    C = idx["C"]
    res = _run_step(idx, queries, M=1)
    mult_ovf = res["mult_ovf"].reshape(-1, C)
    assert mult_ovf.any()  # tandem groups flagged
    anchors, gvalid = res["anchors"], res["gvalid"]
    for b in range(queries.shape[0]):
        th = query_mod.collect_target_hits(_host_raw(idx, queries[b]))
        for c in range(C):
            if mult_ovf[b, c]:
                continue  # incomplete lane, host fallback
            g = b * C + c
            dev = [tuple(int(v) for v in row)
                   for row in anchors[g][gvalid[g]]]
            host = [(*lft, *t) for lft, t in th.get(c, [])]
            assert dev == host


def test_truncated_key_flags_rows():
    """P smaller than a key's postings count sets keyovf at build; any
    query touching that key raises row_ovf (whole-query host fallback)."""
    from pgrtk.ops import query_e2e

    rng = np.random.default_rng(5)
    L, T = 8192, 6
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    targets = np.stack([_mutate(base, 1e-4, rng) for _ in range(T)])
    queries = np.stack([_mutate(base, 1e-4, rng) for _ in range(2)])
    idx = query_e2e.build_index(targets, n_decoys=200, seed=6, P=4)
    assert idx["n_truncated"] > 0  # every shared key has 6 postings > 4
    res = _run_step(idx, queries, M=2)
    assert res["row_ovf"].all()
    # with room for everything, no flag and full parity
    idx2 = query_e2e.build_index(targets, n_decoys=200, seed=6, P=8)
    assert idx2["n_truncated"] == 0
    res2 = _run_step(idx2, queries, M=2)
    assert not res2["row_ovf"].any()
    _assert_anchor_parity(idx2, queries, res2, idx2["C"])


def test_sixty_four_targets():
    """Contig-scale target count: 64 targets, multiplicity-2 block, full
    anchor AND chain parity (VERDICT round-3 task 1 'done' criterion)."""
    from pgrtk.core import query as query_mod
    from pgrtk.ops import chain as chain_ops
    from pgrtk.ops import query_e2e

    rng = np.random.default_rng(12)
    L, T, B = 4096, 64, 2
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    targets = np.stack(
        [_tandem(_mutate(base, 3e-4, rng), 1500, 2300, 2) for _ in range(T)]
    )
    queries = np.stack([_mutate(base, 3e-4, rng) for _ in range(B)])
    idx = query_e2e.build_index(targets, n_decoys=500, seed=13, P=160)
    C = idx["C"]
    assert C == 64
    assert idx["n_multi"] > 0
    assert idx["n_truncated"] == 0
    res = _run_step(idx, queries, M=2, slots2=128)
    assert not bool(res["overflow"])
    assert not res["row_ovf"].any() and not res["mult_ovf"].any()
    assert not res["dup"].any() and not res["inexact"].any()
    n = _assert_anchor_parity(idx, queries, res, C)
    assert n > 0
    dev_chains = chain_ops.traceback(
        res["scores"], res["prev"], res["gvalid"], res["anchors"]
    )
    n_chain_groups = 0
    for b in range(B):
        host = dict(
            query_mod.query_fragment_to_hps(_host_raw(idx, queries[b]), 0.025)
        )
        for c in range(C):
            g = b * C + c
            if int(res["gvalid"][g].sum()) <= 1:
                assert c not in host
                continue
            hch, dch = host[c], dev_chains[g]
            assert len(hch) == len(dch)
            for (hs, htr), (ds, dtr) in zip(hch, dch):
                assert np.float32(hs) == np.float32(ds)
                assert htr == dtr
            n_chain_groups += 1
    assert n_chain_groups >= B * C // 2


def test_in_query_duplicate_pair_count_filter():
    """Round-3 regression: a query with a tandem-duplicated block carries
    duplicate pair keys; with max_count=1 the host pipeline drops their
    hits and the device path must match exactly (and still match at the
    default 128 where the filter does not bind)."""
    from collections import Counter

    from pgrtk.core import query as query_mod
    from pgrtk.ops import query_e2e

    rng = np.random.default_rng(9)
    L, T = 16384, 3
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    targets = np.stack([_mutate(base, 2e-4, rng) for _ in range(T)])
    q = _mutate(base, 2e-4, rng)
    q = np.concatenate([q[:8192], q[4096:8192], q[8192:12288]])
    queries = q[None, :]

    idx = query_e2e.build_index(targets, n_decoys=500, seed=4)
    raw = _host_raw(idx, q)
    counts = Counter(pair for pair, _p, sigs in raw if sigs)
    assert max(counts.values()) >= 2

    for mc in (1, 128):
        res = _run_step(idx, queries, M=2, max_count=mc)
        _assert_anchor_parity(idx, queries, res, idx["C"], max_count=mc)
        if mc == 1:
            n_all = sum(
                len(v) for v in query_mod.collect_target_hits(raw).values()
            )
            n_f = sum(
                len(v)
                for v in query_mod.collect_target_hits(
                    raw, max_count=mc
                ).values()
            )
            assert n_f < n_all  # the filter actually bound


def test_bench_corpus_cnv_tandem_fires_default_filter():
    """Miniature of the round-4 benchmark corpus: a 16-copy CNV tandem
    present in the queries and ONE target only, whose in-query run length
    (16) times per-(key, sid) multiplicity (16) exceeds the reference's
    default max_count_target=128 — the live filter must fire on device
    (n_t_filtered > 0) with zero capacity flags, and the surviving
    anchors must match the host pipeline exactly (which drops the same
    hits, aln.rs:213-221).  A shared tandem-3 block passes the filters
    and contributes multiplicity anchors."""
    from pgrtk.ops import query_e2e
    from pgrtk.utils import synth

    rng = np.random.default_rng(21)
    L, T, B = 49152, 4, 2
    S16, U16, N16 = 8192, 1024, 16
    E16 = S16 + U16 * N16
    S3, U3, N3 = 28672, 2048, 3
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    # a random unit's perfect tandem is often INVISIBLE to the sketch
    # (equal-adjacent-hash mers die to the distinctness rule,
    # shmmrutils.rs:545-548) — pick a unit verified to survive
    base[S16:E16] = np.tile(
        synth.pick_tandem_unit(rng, U16, N16), N16
    )
    base[S3:S3 + U3 * N3] = np.tile(
        rng.integers(0, 4, U3, dtype=np.uint8), N3
    )

    def hap(drop16):
        out = base.copy()
        if drop16:
            out[S16:E16] = rng.integers(0, 4, E16 - S16, dtype=np.uint8)
        n = rng.binomial(L, 2e-4)
        pos = rng.choice(L, size=n, replace=False)
        pos = pos[(pos < S16) | (pos >= E16)]
        out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
        return out

    targets = np.stack([hap(drop16=(sid != 0)) for sid in range(T)])
    queries = np.stack([hap(drop16=False) for _ in range(B)])
    idx = query_e2e.build_index(targets, n_decoys=500, seed=17, P=16)
    assert idx["n_multi"] > 0
    assert idx["n_truncated"] == 0
    # the CNV block keys live in sid 0 only; edge copies may lose a mer
    assert idx["max_mult"] >= N16 - 2

    # repeat-dense content needs the widened level-2 sketch compaction
    # (the tandem sustains ~4-6 raw mers per 512-base chunk)
    res = _run_step(
        idx, queries, M=4, lookback=32, sketch_compact=(12, 512, 192)
    )
    assert not bool(res["overflow"])
    assert not res["row_ovf"].any() and not res["mult_ovf"].any()
    assert not res["dup"].any() and not res["inexact"].any()
    assert int(res["n_t_filtered"]) > 0   # the CNV keys fired the filter
    assert int(res["n_q_filtered"]) == 0  # run_len 16 <= max_count 128
    n = _assert_anchor_parity(idx, queries, res, idx["C"])
    assert n > 0

    # slots3 lane compaction (the bench's chain-depth cut) must be a
    # pure layout change: same anchors, no lane overflow on this corpus
    res_c = _run_step(
        idx, queries, M=4, lookback=32, slots3=128,
        sketch_compact=(12, 512, 192),
    )
    assert not res_c["lane_ovf"].any()
    assert res_c["gvalid"].shape[1] == 128
    n_c = _assert_anchor_parity(idx, queries, res_c, idx["C"])
    assert n_c == n

    # ... and chains stay host-exact through the compacted layout
    from pgrtk.core import query as query_mod
    from pgrtk.ops import chain as chain_ops

    dev_chains = chain_ops.traceback(
        res_c["scores"], res_c["prev"], res_c["gvalid"], res_c["anchors"]
    )
    C = idx["C"]
    n_chain_groups = 0
    for b in range(queries.shape[0]):
        host = dict(
            query_mod.query_fragment_to_hps(_host_raw(idx, queries[b]), 0.025)
        )
        for c in range(C):
            g = b * C + c
            if int(res_c["gvalid"][g].sum()) <= 1:
                assert c not in host
                continue
            hch, dch = host[c], dev_chains[g]
            assert len(hch) == len(dch)
            for (hs, htr), (ds, dtr) in zip(hch, dch):
                assert np.float32(hs) == np.float32(ds)
                assert htr == dtr
            n_chain_groups += 1
    assert n_chain_groups > 0

    # an undersized slots3 must flag, not silently truncate
    res_o = _run_step(
        idx, queries, M=4, slots3=16, sketch_compact=(12, 512, 192)
    )
    assert res_o["lane_ovf"].any()


def test_build_index_from_pair_arrays_matches_seq_build():
    """build_index(pair_arrays=...) must produce identical planes to the
    sequence path (the bench builds from pre-sketched arrays)."""
    from pgrtk.core import sketch as sketch_mod
    from pgrtk.core.spec import ShmmrSpec
    from pgrtk.ops import query_e2e

    rng = np.random.default_rng(2)
    L, T = 8192, 3
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    targets = np.stack(
        [_tandem(_mutate(base, 2e-4, rng), 3000, 4000, 2) for _ in range(T)]
    )
    spec = ShmmrSpec(80, 56, 4, 64, True)
    cols = {kk: [] for kk in ("k0", "k1", "sid", "bgn", "end", "ori")}
    for sid in range(T):
        mx, my = sketch_mod.sequence_to_shmmrs_arrays(
            sid, _to_bytes(targets[sid]), spec, False
        )
        h = (mx >> np.uint64(8)).astype(np.uint64)
        p = ((my & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(
            np.uint32
        ) + np.uint32(1)
        s0, s1 = h[:-1], h[1:]
        swap = s0 > s1
        cols["k0"].append(np.where(swap, s1, s0))
        cols["k1"].append(np.where(swap, s0, s1))
        cols["sid"].append(np.full(len(s0), sid, np.uint32))
        cols["bgn"].append(p[:-1])
        cols["end"].append(p[1:])
        cols["ori"].append(swap.astype(np.uint32))
    arrays = {kk: np.concatenate(v) for kk, v in cols.items()}

    a = query_e2e.build_index(targets, n_decoys=50, seed=3)
    b = query_e2e.build_index(pair_arrays=arrays, n_decoys=50, seed=3)
    assert np.array_equal(a["keys"], b["keys"])
    assert np.array_equal(a["p_rows"], b["p_rows"])
    assert a["lookup"] == b["lookup"]


def test_real_pangenome_content_multiplicity_parity(test_data_dir):
    """Device e2e parity on REAL sequence content: the reference's
    test_seqs.fa (66 HPRC haplotype fragments of one locus,
    pgr-db/test/test_data).  Targets are multi-locus contigs built by
    concatenating 8 real haplotypes each, so shared shimmer-pair keys
    carry GENUINE per-(key, sid) multiplicity (every haplotype copy of
    the locus posts the key); queries are held-out single haplotypes.
    Anchors AND chains must match the host pipeline exactly — on real
    repeats, ragged lengths, and live multiplicity, not synthetic
    mutations."""
    import os

    from pgrtk.core import fasta as fasta_mod
    from pgrtk.core import query as query_mod
    from pgrtk.ops import chain as chain_ops
    from pgrtk.ops import query_e2e

    recs = list(
        fasta_mod.read_fastx(os.path.join(test_data_dir, "test_seqs.fa"))
    )
    assert len(recs) == 66
    code = np.full(256, 255, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        code[ch] = i

    def to2bit(seq):
        arr = code[np.frombuffer(seq, np.uint8)]
        assert (arr != 255).all()
        return arr

    T, PER = 4, 8
    groups = [
        [to2bit(recs[t * PER + j].seq) for j in range(PER)]
        for t in range(T)
    ]
    tl = np.array([sum(len(s) for s in g) for g in groups], np.int32)
    LT = int(tl.max())
    targets = np.zeros((T, LT + (-LT) % 512), np.uint8)
    for t, g in enumerate(groups):
        targets[t, : tl[t]] = np.concatenate(g)

    queries2 = [to2bit(recs[60].seq), to2bit(recs[61].seq)]
    LQ = max(len(q) for q in queries2)
    queries = np.zeros((2, LQ + (-LQ) % 512), np.uint8)
    q_lens = np.array([len(q) for q in queries2], np.int32)
    for b, q in enumerate(queries2):
        queries[b, : q_lens[b]] = q

    # P=48 postings slots/key: a key shared by every haplotype can post
    # up to T*PER = 32 times (plus margin) — the default 16 truncates
    idx = query_e2e.build_index(
        targets, n_decoys=1000, target_lens=tl, P=48
    )
    # 8 real haplotype copies per target -> genuine multiplicity
    assert idx["n_multi"] > 0
    assert idx["n_truncated"] == 0
    assert 2 <= idx["max_mult"] <= 8, idx["max_mult"]
    M = int(idx["max_mult"]) + 1

    import jax
    import jax.numpy as jnp

    probe = idx["probe"]
    res = jax.jit(
        query_e2e.query_e2e_step,
        static_argnames=(
            "probe_bits", "C", "P", "M", "slots2", "max_count",
            "max_count_query", "max_count_target", "lookback", "unroll",
            "max_span", "slots3", "sketch_compact", "probe_aligned",
        ),
    )(
        jnp.asarray(queries),
        jnp.asarray(q_lens),
        probe["bits"],
        [jnp.asarray(probe["planes"][i]) for i in range(4)],
        jnp.asarray(probe["fence_rows"]),  # production fence layout
        jnp.asarray(idx["p_rows"]),
        idx["C"],
        P=idx["P"],
        M=M,
        slots2=128,
        lookback=8 * M,
        probe_aligned=probe.get("aligned", False),
    )
    res = {k: np.asarray(v) for k, v in res.items()}
    assert not bool(res["overflow"])
    assert not res["row_ovf"].any()
    assert not res["mult_ovf"].any()
    assert not res["dup"].any() and not res["inexact"].any()

    C = idx["C"]
    n = _assert_anchor_parity(idx, [q[: q_lens[i]] for i, q in
                                    enumerate(queries)], res, C)
    assert n > 0
    # held-out haplotypes must anchor in EVERY multi-locus target with
    # real multiplicity reaching the device lanes
    anchors, gvalid = res["anchors"], res["gvalid"]
    assert all(
        gvalid[b * C + c].sum() > 0 for b in range(2) for c in range(C)
    )

    dev_chains = chain_ops.traceback(
        res["scores"], res["prev"], res["gvalid"], res["anchors"]
    )
    n_groups = 0
    for b in range(2):
        host = dict(
            query_mod.query_fragment_to_hps(
                _host_raw(idx, queries[b][: q_lens[b]]), 0.025
            )
        )
        for c in range(C):
            g = b * C + c
            if int(gvalid[g].sum()) <= 1:
                assert c not in host
                continue
            hchains, dchains = host[c], dev_chains[g]
            assert len(hchains) == len(dchains)
            for (hs, htrack), (ds, dtrack) in zip(hchains, dchains):
                assert np.float32(hs) == np.float32(ds)
                assert htrack == dtrack
            n_groups += 1
    assert n_groups == 2 * C


def test_aligned_bucket_skew_retries_and_adversarial_raises():
    """A skewed key set (hot bucket at lambda=32 that SPLITS at smaller
    lambda) must build via the bits-retry; keys sharing their entire
    top-24-bit h0 prefix >128 deep cannot be bucketed and must raise a
    clear error (canonical Wang-hash pairs cannot do that without
    adversarial construction)."""
    from pgrtk.ops import query_e2e

    rng = np.random.default_rng(4)

    def arrays_for(k0, k1):
        n = len(k0)
        order = np.lexsort((k1, k0))
        return dict(
            k0=k0[order], k1=k1[order],
            sid=np.zeros(n, np.uint32),
            bgn=(np.arange(n, dtype=np.uint32) * 100 + 1),
            end=(np.arange(n, dtype=np.uint32) * 100 + 80),
            ori=np.zeros(n, np.uint32),
        )

    # skewed: 300 keys share the top ~14 bits but differ below -> hot at
    # the default lambda sizing for n=2300, split by the retry
    n_bg = 2000
    bg0 = rng.integers(1 << 40, 1 << 56, size=n_bg, dtype=np.uint64)
    # share only the top 8 (of 56) bits: hot at lambda=32 (7 bucket
    # bits) and lambda=8 (9 bits -> 2 buckets of ~150), split at
    # lambda=2 (11 bits -> ~8 buckets)
    hot0 = (np.uint64(0x3A) << np.uint64(48)) + rng.integers(
        0, 1 << 48, size=300, dtype=np.uint64
    )
    k0 = np.concatenate([bg0, hot0])
    k1 = rng.integers(0, 1 << 56, size=len(k0), dtype=np.uint64)
    idx = query_e2e.build_index(
        pair_arrays=arrays_for(k0, k1), n_decoys=0, P=16
    )
    assert idx["probe"].get("aligned") is True  # retry succeeded

    # adversarial: 700 distinct pairs, 4 distinct h0 values -> one
    # bucket at every lambda
    a0 = np.full(700, 0x00123456789A, np.uint64) + (
        np.arange(700, dtype=np.uint64) % np.uint64(4)
    )
    a1 = rng.integers(0, 1 << 56, size=700, dtype=np.uint64)
    with pytest.raises(ValueError, match="adversarial"):
        query_e2e.build_index(
            pair_arrays=arrays_for(a0, a1), n_decoys=0, P=16
        )


@pytest.mark.parametrize("seed", [11, 23, 37, 51, 64])
def test_randomized_corpora_device_host_parity(seed):
    """Property sweep: random mini-pangenomes with randomized tandem
    geometry (unit length, copy count, placement) and SNP rates — the
    device step's anchors must equal the host pipeline's count-filtered
    hits for every (query, target) on every seed, with capacity flags
    clean (or the affected lanes flagged, never silently wrong)."""
    from pgrtk.ops import query_e2e

    rng = np.random.default_rng(seed)
    L = int(rng.integers(8192, 20000))
    T = int(rng.integers(2, 6))
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    copies = int(rng.integers(2, 5))
    u0 = int(rng.integers(512, 2048))
    s0 = int(rng.integers(100, L - u0 * (copies + 1) - 100))

    def make(rate):
        s = _mutate(base, rate, rng)
        return _tandem(s, s0, s0 + u0, copies)

    targets = np.stack([make(2e-4) for _ in range(T)])
    queries = np.stack([make(3e-4) for _ in range(2)])
    idx = query_e2e.build_index(
        targets, n_decoys=int(rng.integers(0, 3000)), seed=seed, P=32
    )
    assert idx["n_truncated"] == 0
    M = max(2, int(idx["max_mult"]) + 1)
    res = _run_step(
        idx, queries, M=M, slots2=256, lookback=8 * M
    )
    assert not bool(res["overflow"])
    assert not res["row_ovf"].any() and not res["mult_ovf"].any()
    # groups the fast chain kernel flags would be host-fallback routed;
    # anchors must be exact regardless
    n = _assert_anchor_parity(idx, queries, res, idx["C"])
    assert n > 0
