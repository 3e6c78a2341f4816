"""Device pair-construction and sharded pipeline tests (CPU backend,
virtual 8-device mesh via conftest)."""
import os

import numpy as np
import pytest

from pgrtk.core import sketch_ref
from pgrtk.core.fasta import read_fastx_all
from pgrtk.core.spec import ShmmrSpec

SPEC = ShmmrSpec(sketch=True)


def _expected_pairs(seqs, spec):
    """Reference-derived canonical pair multiset {key -> [(sid,bgn,end,ori)]}."""
    out = {}
    for sid, s in enumerate(seqs):
        mers = sketch_ref.sequence_to_shmmrs(sid, s, spec)
        for i in range(len(mers) - 1):
            h0 = mers[i][0] >> 8
            h1 = mers[i + 1][0] >> 8
            p0 = ((mers[i][1] & 0xFFFFFFFF) >> 1) + 1
            p1 = ((mers[i + 1][1] & 0xFFFFFFFF) >> 1) + 1
            if h0 <= h1:
                key, ori = (h0, h1), 0
            else:
                key, ori = (h1, h0), 1
            out.setdefault(key, []).append((sid, p0, p1, ori))
    return out


def _device_table(seqs, spec, capacity=512, gapped=True):
    import jax.numpy as jnp

    from pgrtk.ops import pairs as pairs_ops
    from pgrtk.ops import sketch as dsk

    arr, lens = dsk.pad_batch([s for s in seqs], multiple=512)
    out = dsk.sketch_mode2_dense(
        jnp.asarray(arr),
        jnp.asarray(lens),
        jnp.arange(len(seqs), dtype=jnp.uint32),
        spec.k,
        spec.r,
        spec.min_span,
        512,
    )
    xh, xl, yl, valid, ovf = pairs_ops.compact_mers(
        out["x_hi"], out["x_lo"], out["y_lo"], out["selected"], capacity
    )
    assert not bool(ovf)
    keep = pairs_ops.min_span_filter_dense(xh, xl, yl, valid, spec.min_span)
    if gapped:
        pr = pairs_ops.pair_mers_gapped(xh, xl, yl, keep)
    else:
        xh, xl, yl, valid = pairs_ops.recompact_mers(xh, xl, yl, keep)
        pr = pairs_ops.pair_mers_dense(xh, xl, yl, valid)
    table = pairs_ops.sort_pairs(
        pr, jnp.arange(len(seqs), dtype=jnp.uint32)
    )
    return {k: np.asarray(v) for k, v in table.items()}


@pytest.mark.parametrize("gapped", [True, False])
def test_device_pair_table_matches_reference(test_data_dir, gapped):
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))[:16]
    seqs = [r.seq for r in recs]
    expected = _expected_pairs(seqs, SPEC)
    table = _device_table(seqs, SPEC, gapped=gapped)
    valid = table["valid"]
    n = valid.sum()
    assert n == sum(len(v) for v in expected.values())
    got = {}
    k0 = (table["k0_hi"].astype(np.uint64) << np.uint64(32)) | table["k0_lo"]
    k1 = (table["k1_hi"].astype(np.uint64) << np.uint64(32)) | table["k1_lo"]
    for i in np.flatnonzero(valid):
        got.setdefault((int(k0[i]), int(k1[i])), []).append(
            (
                int(table["sid"][i]),
                int(table["bgn"][i]),
                int(table["end"][i]),
                int(table["orientation"][i]),
            )
        )
    assert got == expected
    # sortedness: valid prefix of keys non-decreasing
    kk = np.stack([k0[valid], k1[valid]], axis=1)
    assert all(
        tuple(kk[i]) <= tuple(kk[i + 1]) for i in range(len(kk) - 1)
    )


def test_dryrun_multichip_smoke():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_jits():
    import sys

    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    scores, gvalid, overflow = out
    assert not bool(overflow)
    assert int(np.asarray(gvalid).sum()) > 50  # real anchors flowed through


def test_scaling_harness_runs():
    from pgrtk.parallel import distributed

    res = distributed.measure_index_scaling(
        [1, 2], per_device_batch=1, seq_len=1 << 14, iters=1
    )
    assert len(res) == 2
    assert all(rate > 0 for _n, _t, _dt, rate in res)
    assert 0 < distributed.scaling_efficiency(res)


def test_sharded_index_v2_matches_v1():
    """Hash-range-sharded v2 index: the union of per-device shards is
    exactly the v1 replicated table, and v2 query fan-out (all_gather
    keys + per-shard search + psum) finds the same hits."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgrtk.parallel import mesh as pmesh

    n = 8
    mesh = pmesh.make_mesh(n)
    axis = mesh.axis_names[0]
    B, L = 2 * n, 4096
    rng = np.random.default_rng(5)
    seqs = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    shard = NamedSharding(mesh, P(axis, None))
    shard1 = NamedSharding(mesh, P(axis))
    sd = jax.device_put(jnp.asarray(seqs), shard)
    ld = jax.device_put(jnp.full(B, L, dtype=jnp.int32), shard1)
    rd = jax.device_put(jnp.arange(B, dtype=jnp.uint32), shard1)

    v1 = pmesh.sharded_sketch_index_step(mesh, chunk=512)(sd, ld, rd)
    t1 = v1["table"]
    valid1 = np.asarray(t1["valid"])
    keys1 = {
        (
            int(np.asarray(t1["k0_hi"])[j]), int(np.asarray(t1["k0_lo"])[j]),
            int(np.asarray(t1["k1_hi"])[j]), int(np.asarray(t1["k1_lo"])[j]),
            int(np.asarray(t1["sid"])[j]), int(np.asarray(t1["bgn"])[j]),
        )
        for j in np.flatnonzero(valid1)
    }

    cap = max(128, 2 * len(keys1) // n)
    v2 = pmesh.sharded_index_v2_step(mesh, cap, chunk=512)(sd, ld, rd)
    assert not bool(v2["shard_overflow"])
    assert not bool(v2["route_overflow"])
    assert not bool(v2["probe_overflow"])
    assert not bool(v2["compact_overflow"])
    assert int(v2["n_pairs"]) == len(keys1)
    sh = v2["shard"]
    valid2 = np.asarray(sh["valid"])
    keys2 = {
        (
            int(np.asarray(sh["k0_hi"])[j]), int(np.asarray(sh["k0_lo"])[j]),
            int(np.asarray(sh["k1_hi"])[j]), int(np.asarray(sh["k1_lo"])[j]),
            int(np.asarray(sh["sid"])[j]), int(np.asarray(sh["bgn"])[j]),
        )
        for j in np.flatnonzero(valid2)
    }
    assert keys2 == keys1

    qstep = pmesh.sharded_query_v2_step(mesh, cap, chunk=512)
    planes = tuple(
        jax.device_put(p, NamedSharding(mesh, P(axis)))
        for p in v2["probe"]["planes"][:4]  # key planes (5-7 = postings)
    )
    n_hits, _found, q_ovf = qstep(sd, ld, rd, *planes)
    assert not bool(q_ovf)
    # self-query: every indexed pair key must be found
    assert int(n_hits) >= int(v2["n_pairs"])


def test_device_pipeline_parity_at_batch_scale():
    """Full device index pipeline (packed compaction + gapped filter/pair
    + key sort) against the scalar reference on a synthetic 0.5 Mbase
    batch — guards the whole fast path, not just small real sequences."""
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [
        bases[rng.integers(0, 4, size=n)].tobytes()
        for n in (65536, 64000, 32768, 10007, 65536, 50000, 4096, 65536)
    ]
    expected = _expected_pairs(seqs, SPEC)

    import jax.numpy as jnp

    from pgrtk.ops import pairs as pairs_ops
    from pgrtk.ops import sketch as dsk

    arr, lens = dsk.pad_batch(seqs, multiple=512)
    out = dsk.sketch_mode2_dense(
        jnp.asarray(arr), jnp.asarray(lens),
        jnp.arange(len(seqs), dtype=jnp.uint32),
        SPEC.k, SPEC.r, SPEC.min_span, 512,
    )
    xh, xl, yl, valid, ovf = pairs_ops.compact_mers_packed(
        out["x_hi"], out["x_lo"], out["y_lo"], out["selected"]
    )
    assert not bool(ovf)
    keep = pairs_ops.min_span_filter_gapped(xh, xl, yl, valid, SPEC.min_span)
    pr = pairs_ops.pair_mers_gapped(xh, xl, yl, keep)
    table = pairs_ops.sort_pairs(pr, jnp.arange(len(seqs), dtype=jnp.uint32))

    va = np.asarray(table["valid"])
    k0 = (np.asarray(table["k0_hi"]).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(table["k0_lo"])
    k1 = (np.asarray(table["k1_hi"]).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(table["k1_lo"])
    got = {}
    for i in np.flatnonzero(va):
        got.setdefault((int(k0[i]), int(k1[i])), []).append(
            (
                int(np.asarray(table["sid"])[i]),
                int(np.asarray(table["bgn"])[i]),
                int(np.asarray(table["end"])[i]),
                int(np.asarray(table["orientation"])[i]),
            )
        )
    assert sum(len(v) for v in got.values()) == \
        sum(len(v) for v in expected.values())
    assert got == expected


def test_sort_pairs_packed_matches_sort_pairs():
    """The packed-key sort (4 lexicographic u32 words + stable sort)
    must reproduce sort_pairs' table exactly on the valid prefix,
    including postings order under heavy key duplication."""
    import jax.numpy as jnp

    from pgrtk.ops import pairs as pairs_ops

    rng = np.random.default_rng(42)
    B, C = 8, 2048
    h0 = rng.integers(0, 1 << 56, size=(B, C), dtype=np.uint64)
    h1 = rng.integers(0, 1 << 56, size=(B, C), dtype=np.uint64)
    dup = rng.random((B, C)) < 0.3  # heavy duplication -> tie order
    h0[dup] = h0[0, 0]
    h1[dup] = h1[0, 0]
    swap = h0 > h1
    k0 = np.where(swap, h1, h0)
    k1 = np.where(swap, h0, h1)
    pos = np.sort(
        rng.integers(1, 1 << 20, size=(B, C)).astype(np.uint32), axis=1
    )
    valid = rng.random((B, C)) < 0.9
    pairs = dict(
        k0_hi=jnp.asarray((k0 >> 32).astype(np.uint32)),
        k0_lo=jnp.asarray((k0 & 0xFFFFFFFF).astype(np.uint32)),
        k1_hi=jnp.asarray((k1 >> 32).astype(np.uint32)),
        k1_lo=jnp.asarray((k1 & 0xFFFFFFFF).astype(np.uint32)),
        bgn=jnp.asarray(pos),
        end=jnp.asarray(pos + 7),
        orientation=jnp.asarray(swap.astype(np.uint32)),
        pair_valid=jnp.asarray(valid),
    )
    sid = jnp.arange(B, dtype=jnp.uint32)
    a = {k: np.asarray(v) for k, v in pairs_ops.sort_pairs(pairs, sid).items()}
    b = {
        k: np.asarray(v)
        for k, v in pairs_ops.sort_pairs_packed(pairs, sid).items()
    }
    nv = a["valid"].sum()
    assert nv == b["valid"].sum()
    for k in ("k0_hi", "k0_lo", "k1_hi", "k1_lo", "sid", "bgn", "end",
              "orientation"):
        assert np.array_equal(a[k][:nv], b[k][:nv]), k


def test_compact_overflow_flag_and_safe_rerun():
    """The aggressive default compaction sizing must FLAG dense clusters
    (never drop silently), and the SAFE_COMPACT_KW rerun must hold them."""
    import jax.numpy as jnp

    from pgrtk.ops import pairs as pairs_ops

    B, L = 2, 4096
    rng = np.random.RandomState(3)
    x_hi = jnp.asarray(rng.randint(0, 1 << 31, size=(B, L)).astype(np.uint32))
    x_lo = jnp.asarray(rng.randint(0, 1 << 31, size=(B, L)).astype(np.uint32))
    pos = np.arange(L, dtype=np.uint32)[None, :].repeat(B, 0)
    y_lo = jnp.asarray(pos << 1)
    sel = np.zeros((B, L), dtype=bool)
    sel[0, 100:115] = True  # 15 selected inside one 512-block: > 12 slots
    xh, xl, yl, valid, ovf = pairs_ops.compact_mers_packed(
        x_hi, x_lo, y_lo, jnp.asarray(sel)
    )
    assert bool(ovf), "default sizing must flag a 15-dense block"
    xh, xl, yl, valid, ovf = pairs_ops.compact_mers_packed(
        x_hi, x_lo, y_lo, jnp.asarray(sel), **pairs_ops.SAFE_COMPACT_KW
    )
    assert not bool(ovf)
    assert int(valid.sum()) == 15
    got_pos = np.sort(np.asarray(yl)[np.asarray(valid)] >> 1)
    assert np.array_equal(got_pos, np.arange(100, 115))


def test_index_step_auto_rerun_on_overflow():
    """A dense periodic repeat (16 selected mers in one 512 window)
    overflows the fast fused step's 12-slot compaction; the _auto driver
    must detect it, rerun at SAFE_COMPACT_KW sizing, and produce the
    exact scalar-reference pair table."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgrtk.parallel import mesh as pmesh

    # period-11 motif whose phase-4 56-mer hashes under the mode-2
    # threshold: every 11th position of the run is selected
    motif = [0, 0, 1, 2, 0, 0, 0, 2, 0, 0, 1]  # AACGAAAGAAC
    rng = np.random.default_rng(7)
    B, L = 8, 4096
    seqs = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    run = (motif * 24)[: 56 + 14 * 11]
    seqs[0, 1088 : 1088 + len(run)] = run

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    expected = _expected_pairs(
        [bases[row].tobytes() for row in seqs], SPEC
    )

    n = 8
    mesh = pmesh.make_mesh(n)
    axis = mesh.axis_names[0]
    sd = jax.device_put(jnp.asarray(seqs), NamedSharding(mesh, P(axis, None)))
    ld = jax.device_put(
        jnp.full(B, L, dtype=jnp.int32), NamedSharding(mesh, P(axis))
    )
    rd = jax.device_put(
        jnp.arange(B, dtype=jnp.uint32), NamedSharding(mesh, P(axis))
    )

    # the plain fast step must FLAG the overflow
    fast_out = pmesh.sharded_sketch_index_step(mesh, chunk=512)(sd, ld, rd)
    assert bool(fast_out["overflow"])

    # ... and the auto driver must recover exactly
    out = pmesh.sharded_sketch_index_step_auto(mesh, chunk=512)(sd, ld, rd)
    assert not bool(out["overflow"])
    t = out["table"]
    valid = np.asarray(t["valid"])
    k0 = (np.asarray(t["k0_hi"]).astype(np.uint64) << np.uint64(32)) | np.asarray(t["k0_lo"])
    k1 = (np.asarray(t["k1_hi"]).astype(np.uint64) << np.uint64(32)) | np.asarray(t["k1_lo"])
    got = {}
    for j in np.flatnonzero(valid):
        got.setdefault((int(k0[j]), int(k1[j])), []).append(
            (int(np.asarray(t["sid"])[j]), int(np.asarray(t["bgn"])[j]),
             int(np.asarray(t["end"])[j]), int(np.asarray(t["orientation"])[j]))
        )
    assert got == expected


def test_sharded_e2e_query_content_matches_host_pipeline():
    """Distributed end-to-end query (v2 sharded build -> route -> probe
    -> postings extraction -> route back -> chain) must produce the host
    pipeline's anchors and chains EXACTLY, per (query, target) group."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgrtk.core import query as query_mod
    from pgrtk.ops import chain as chain_ops
    from pgrtk.ops import query_e2e
    from pgrtk.parallel import mesh as pmesh

    B, L = 8, 16384
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    seqs = np.stack([base.copy() for _ in range(B)])
    for b in range(B):  # mutated copies => multi-target postings
        n = rng.binomial(L, 3e-4)
        pos = rng.choice(L, size=n, replace=False)
        seqs[b, pos] = (seqs[b, pos] + rng.integers(1, 4, size=n)) % 4

    mesh = pmesh.make_mesh(8)
    axis = mesh.axis_names[0]
    shard = NamedSharding(mesh, P(axis, None))
    shard1 = NamedSharding(mesh, P(axis))
    seqs_d = jax.device_put(jnp.asarray(seqs), shard)
    lens_d = jax.device_put(jnp.full(B, L, jnp.int32), shard1)
    rids_d = jax.device_put(jnp.arange(B, dtype=jnp.uint32), shard1)

    cap = 4096
    v2 = pmesh.sharded_index_v2_step(mesh, cap, chunk=512)(
        seqs_d, lens_d, rids_d
    )
    assert not bool(v2["shard_overflow"]) and not bool(v2["probe_overflow"])
    e2e = pmesh.sharded_query_v2_e2e_step(
        mesh, cap, n_targets=B, slots2=96
    )(seqs_d, lens_d, rids_d, *v2["probe"]["planes"])
    for flag in ("compact_overflow", "route_overflow", "postings_overflow"):
        assert not bool(e2e[flag]), flag
    assert not np.asarray(e2e["row_ovf"]).any()
    assert not np.asarray(e2e["mult_ovf"]).any()
    anchors = np.asarray(e2e["anchors"])
    gvalid = np.asarray(e2e["gvalid"])
    scores = np.asarray(e2e["scores"])
    prev = np.asarray(e2e["prev"])
    assert not np.asarray(e2e["dup"]).any()
    assert not np.asarray(e2e["inexact"]).any()

    # host arbiter: same corpus, same builder semantics
    idx = query_e2e.build_synth_index(seqs, n_decoys=0)
    assert idx["n_multi_dropped"] == 0
    lookup = idx["lookup"]
    spec = ShmmrSpec(80, 56, 4, 64, True)
    BASES = b"ACGT"
    dev_chains = chain_ops.traceback(scores, prev, gvalid, anchors)
    n_checked = 0
    for b in range(B):
        qbytes = bytes(bytearray(BASES[v] for v in seqs[b]))
        raw = query_mod.raw_query_fragment(
            lambda s0, s1: lookup.get((s0, s1), []), qbytes, spec
        )
        th = query_mod.collect_target_hits(raw)
        host_chains = dict(query_mod.query_fragment_to_hps(raw, 0.025))
        for c in range(B):
            g = b * B + c
            dev = [
                tuple(int(v) for v in row)
                for row in anchors[g][gvalid[g]]
            ]
            host = [(*lft, *t) for lft, t in th.get(c, [])]
            assert dev == host, f"anchor mismatch b={b} sid={c}"
            if len(host) > 1:
                hch = host_chains[c]
                dch = dev_chains[g]
                assert len(hch) == len(dch)
                for (hs, htr), (ds, dtr) in zip(hch, dch):
                    assert np.float32(hs) == np.float32(ds)
                    assert htr == dtr
                n_checked += 1
    assert n_checked == B * B  # every (query, target) group had chains


def test_sharded_e2e_count_filter_binds():
    """Queries with tandem-duplicated blocks carry duplicate pair keys;
    the sharded e2e step's in-query count filter must drop their hits
    exactly like the host pipeline at max_count=1."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgrtk.core import query as query_mod
    from pgrtk.core.spec import ShmmrSpec
    from pgrtk.ops import query_e2e
    from pgrtk.parallel import mesh as pmesh

    B, L = 8, 16384
    rng = np.random.default_rng(21)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    corpus = np.stack([base.copy() for _ in range(B)])
    for b in range(B):
        n = rng.binomial(L, 3e-4)
        pos = rng.choice(L, size=n, replace=False)
        corpus[b, pos] = (corpus[b, pos] + rng.integers(1, 4, size=n)) % 4
    # query batch: middle block tandem-duplicated => duplicate pairs
    queries = np.stack(
        [
            np.concatenate([q[:8192], q[4096:8192], q[8192:12288]])
            for q in corpus
        ]
    )
    LQ = queries.shape[1]

    mesh = pmesh.make_mesh(8)
    axis = mesh.axis_names[0]
    shard = NamedSharding(mesh, P(axis, None))
    shard1 = NamedSharding(mesh, P(axis))
    c_d = jax.device_put(jnp.asarray(corpus), shard)
    cl_d = jax.device_put(jnp.full(B, L, jnp.int32), shard1)
    rids_d = jax.device_put(jnp.arange(B, dtype=jnp.uint32), shard1)
    q_d = jax.device_put(jnp.asarray(queries), shard)
    ql_d = jax.device_put(jnp.full(B, LQ, jnp.int32), shard1)

    cap = 4096
    v2 = pmesh.sharded_index_v2_step(mesh, cap, chunk=512)(c_d, cl_d, rids_d)
    assert not bool(v2["shard_overflow"])
    e2e = pmesh.sharded_query_v2_e2e_step(
        mesh, cap, n_targets=B, slots2=96, max_count=1
    )(q_d, ql_d, rids_d, *v2["probe"]["planes"])
    assert not bool(e2e["postings_overflow"])
    anchors = np.asarray(e2e["anchors"])
    gvalid = np.asarray(e2e["gvalid"])

    idx = query_e2e.build_synth_index(corpus, n_decoys=0)
    lookup = idx["lookup"]
    spec = ShmmrSpec(80, 56, 4, 64, True)
    BASES = b"ACGT"
    n_bound = 0
    for b in range(B):
        qbytes = bytes(bytearray(BASES[v] for v in queries[b]))
        raw = query_mod.raw_query_fragment(
            lambda s0, s1: lookup.get((s0, s1), []), qbytes, spec
        )
        th1 = query_mod.collect_target_hits(raw, max_count=1)
        th_all = query_mod.collect_target_hits(raw)
        if sum(len(v) for v in th1.values()) < sum(
            len(v) for v in th_all.values()
        ):
            n_bound += 1
        for c in range(B):
            g = b * B + c
            dev = [tuple(int(v) for v in row)
                   for row in anchors[g][gvalid[g]]]
            host = [(*lft, *t) for lft, t in th1.get(c, [])]
            assert dev == host, f"b={b} sid={c}"
    assert n_bound == B  # every query had duplicate pairs to drop


def test_sharded_count_filter_is_per_query_at_b_loc_2():
    """Regression (round-3 review): with more queries than devices
    (B_loc > 1), the in-query duplicate-pair count must NOT merge runs
    across the queries sharing a device — two queries each carrying a
    duplicated block stay under a cap that their merged counts would
    exceed."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgrtk.core import query as query_mod
    from pgrtk.core.spec import ShmmrSpec
    from pgrtk.ops import query_e2e
    from pgrtk.parallel import mesh as pmesh

    B, L = 8, 16384
    rng = np.random.default_rng(33)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    corpus = np.stack([base.copy() for _ in range(B)])
    for b in range(B):
        n = rng.binomial(L, 3e-4)
        pos = rng.choice(L, size=n, replace=False)
        corpus[b, pos] = (corpus[b, pos] + rng.integers(1, 4, size=n)) % 4
    # every query: ONE duplicated block => per-query pair count 2; a
    # cross-query count on a 2-query device would see 4 > cap=3
    queries = np.stack(
        [
            np.concatenate([q[:8192], q[4096:8192], q[8192:12288]])
            for q in corpus
        ]
    )
    LQ = queries.shape[1]

    mesh = pmesh.make_mesh(4)  # 8 queries over 4 devices -> B_loc = 2
    axis = mesh.axis_names[0]
    shard = NamedSharding(mesh, P(axis, None))
    shard1 = NamedSharding(mesh, P(axis))
    c_d = jax.device_put(jnp.asarray(corpus), shard)
    cl_d = jax.device_put(jnp.full(B, L, jnp.int32), shard1)
    rids_d = jax.device_put(jnp.arange(B, dtype=jnp.uint32), shard1)
    q_d = jax.device_put(jnp.asarray(queries), shard)
    ql_d = jax.device_put(jnp.full(B, LQ, jnp.int32), shard1)

    cap = 8192
    v2 = pmesh.sharded_index_v2_step(mesh, cap, chunk=512)(c_d, cl_d, rids_d)
    e2e = pmesh.sharded_query_v2_e2e_step(
        mesh, cap, n_targets=B, slots2=96, max_count=3
    )(q_d, ql_d, rids_d, *v2["probe"]["planes"])
    anchors = np.asarray(e2e["anchors"])
    gvalid = np.asarray(e2e["gvalid"])

    idx = query_e2e.build_synth_index(corpus, n_decoys=0)
    lookup = idx["lookup"]
    spec = ShmmrSpec(80, 56, 4, 64, True)
    BASES = b"ACGT"
    for b in range(B):
        qbytes = bytes(bytearray(BASES[v] for v in queries[b]))
        raw = query_mod.raw_query_fragment(
            lambda s0, s1: lookup.get((s0, s1), []), qbytes, spec
        )
        th = query_mod.collect_target_hits(raw, max_count=3)
        for c in range(B):
            g = b * B + c
            dev = [tuple(int(v) for v in row)
                   for row in anchors[g][gvalid[g]]]
            host = [(*lft, *t) for lft, t in th.get(c, [])]
            assert dev == host, f"b={b} sid={c}"


def test_sharded_e2e_query_multiplicity_and_ragged():
    """General-layout distributed e2e (round-4 VERDICT task 1): targets
    carry a tandem-TRIPLED block (per-(key, sid) multiplicity 3 in the
    shard postings), query lengths are RAGGED across devices, and the
    per-target count filter runs live — anchors and chains must match
    the host pipeline exactly, with no overflow flags."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgrtk.core import query as query_mod
    from pgrtk.ops import chain as chain_ops
    from pgrtk.ops import query_e2e
    from pgrtk.parallel import mesh as pmesh

    B, L = 8, 16384
    rng = np.random.default_rng(41)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)

    def mutate(seq, rate):
        out = seq.copy()
        n = rng.binomial(len(seq), rate)
        pos = rng.choice(len(seq), size=n, replace=False)
        out[pos] = (out[pos] + rng.integers(1, 4, size=n)) % 4
        return out

    def tandem(seq, bgn, end, copies):
        return np.concatenate(
            [seq[:end]] + [seq[bgn:end]] * (copies - 1) + [seq[end:]]
        )

    # targets: tripled 1.5-kb block => multiplicity-3 postings runs
    targets = np.stack(
        [tandem(mutate(base, 2e-4), 4000, 8000, 3) for _ in range(B)]
    )
    LT = targets.shape[1]
    pad = (-LT) % 512
    targets_p = np.pad(targets, ((0, 0), (0, pad)))
    # queries: ragged true lengths (trailing bases cut per device)
    qfull = np.stack([mutate(base, 2e-4) for _ in range(B)])
    qlens = np.asarray(
        [L - 512 * (b % 4) for b in range(B)], dtype=np.int32
    )
    for b in range(B):
        qfull[b, qlens[b]:] = 0

    mesh = pmesh.make_mesh(8)
    axis = mesh.axis_names[0]
    shard = NamedSharding(mesh, P(axis, None))
    shard1 = NamedSharding(mesh, P(axis))
    t_d = jax.device_put(jnp.asarray(targets_p), shard)
    tl_d = jax.device_put(jnp.full(B, LT, jnp.int32), shard1)
    rids_d = jax.device_put(jnp.arange(B, dtype=jnp.uint32), shard1)
    q_d = jax.device_put(jnp.asarray(qfull), shard)
    ql_d = jax.device_put(jnp.asarray(qlens), shard1)

    cap = 8192
    v2 = pmesh.sharded_index_v2_step(mesh, cap, chunk=512)(t_d, tl_d, rids_d)
    assert not bool(v2["shard_overflow"]) and not bool(v2["probe_overflow"])
    e2e = pmesh.sharded_query_v2_e2e_step(
        mesh, cap, n_targets=B, slots2=96, M=4, postings_cap=32,
        slots3=192,  # per-lane anchor compaction (bench layout) in play
    )(q_d, ql_d, rids_d, *v2["probe"]["planes"])
    for flag in ("compact_overflow", "route_overflow", "postings_overflow"):
        assert not bool(e2e[flag]), flag
    assert not np.asarray(e2e["row_ovf"]).any()
    assert not np.asarray(e2e["mult_ovf"]).any()
    assert not np.asarray(e2e["lane_ovf"]).any()
    assert np.asarray(e2e["gvalid"]).shape[1] == 192
    anchors = np.asarray(e2e["anchors"])
    gvalid = np.asarray(e2e["gvalid"])
    scores = np.asarray(e2e["scores"])
    prev = np.asarray(e2e["prev"])
    dup = np.asarray(e2e["dup"])
    inexact = np.asarray(e2e["inexact"])

    # host arbiter over the same corpus (multiplicity-3 index)
    idx = query_e2e.build_index(targets, n_decoys=0)
    assert idx["n_multi"] > 0
    lookup = idx["lookup"]
    spec = ShmmrSpec(80, 56, 4, 64, True)
    BASES = b"ACGT"
    dev_chains = chain_ops.traceback(scores, prev, gvalid, anchors)
    n_anchors_total = 0
    n_chain_groups = 0
    for b in range(B):
        qbytes = bytes(
            bytearray(BASES[v] for v in qfull[b, : qlens[b]])
        )
        raw = query_mod.raw_query_fragment(
            lambda s0, s1: lookup.get((s0, s1), []), qbytes, spec
        )
        th = query_mod.collect_target_hits(raw)
        host_chains = dict(query_mod.query_fragment_to_hps(raw, 0.025))
        for c in range(B):
            g = b * B + c
            dev = [tuple(int(v) for v in row)
                   for row in anchors[g][gvalid[g]]]
            host = [(*lft, *t) for lft, t in th.get(c, [])]
            assert dev == host, f"anchor mismatch b={b} sid={c}"
            n_anchors_total += len(host)
            if not dup[g] and not inexact[g] and len(host) > 1:
                hch, dch = host_chains[c], dev_chains[g]
                assert len(hch) == len(dch), (b, c)
                for (hs, htr), (ds, dtr) in zip(hch, dch):
                    assert np.float32(hs) == np.float32(ds), (b, c)
                    assert htr == dtr, (b, c)
                n_chain_groups += 1
    assert n_anchors_total > 0
    assert n_chain_groups >= (B * B) * 8 // 10


def test_sharded_e2e_query_sixty_four_targets():
    """Contig-scale target counts through the DISTRIBUTED path: 64
    sequences (8 per device) self-queried over the v2 sharded index —
    64x64 = 4096 (query, target) chain lanes — with exact anchor parity
    per group (round-3 verdict: the old layout's static slot loop was
    C=8 in every parity run; the general layout must hold at 64)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgrtk.core import query as query_mod
    from pgrtk.ops import query_e2e
    from pgrtk.parallel import mesh as pmesh

    B, L = 64, 4096
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    seqs = np.stack([base.copy() for _ in range(B)])
    for b in range(B):
        n = rng.binomial(L, 5e-4)
        pos = rng.choice(L, size=n, replace=False)
        seqs[b, pos] = (seqs[b, pos] + rng.integers(1, 4, size=n)) % 4

    mesh = pmesh.make_mesh(8)
    axis = mesh.axis_names[0]
    seqs_d = jax.device_put(
        jnp.asarray(seqs), NamedSharding(mesh, P(axis, None))
    )
    lens_d = jax.device_put(
        jnp.full(B, L, jnp.int32), NamedSharding(mesh, P(axis))
    )
    rids_d = jax.device_put(
        jnp.arange(B, dtype=jnp.uint32), NamedSharding(mesh, P(axis))
    )

    cap = 8192
    v2 = pmesh.sharded_index_v2_step(mesh, cap, chunk=512)(
        seqs_d, lens_d, rids_d
    )
    assert not bool(v2["shard_overflow"]) and not bool(v2["probe_overflow"])
    # every key posts in ~64 targets: postings_cap must cover it
    e2e = pmesh.sharded_query_v2_e2e_step(
        mesh, cap, n_targets=B, slots2=64, postings_cap=96
    )(seqs_d, lens_d, rids_d, *v2["probe"]["planes"])
    for flag in ("compact_overflow", "route_overflow", "postings_overflow"):
        assert not bool(e2e[flag]), flag
    assert not np.asarray(e2e["row_ovf"]).any()
    assert not np.asarray(e2e["mult_ovf"]).any()
    anchors = np.asarray(e2e["anchors"])
    gvalid = np.asarray(e2e["gvalid"])

    idx = query_e2e.build_index(seqs, n_decoys=0, P=96)
    assert idx["n_truncated"] == 0
    lookup = idx["lookup"]
    spec = ShmmrSpec(80, 56, 4, 64, True)
    BASES = b"ACGT"
    n_anchors = 0
    for b in range(0, B, 7):  # sampled queries; every target checked
        qbytes = bytes(bytearray(BASES[v] for v in seqs[b]))
        raw = query_mod.raw_query_fragment(
            lambda s0, s1: lookup.get((s0, s1), []), qbytes, spec
        )
        th = query_mod.collect_target_hits(raw)
        for c in range(B):
            g = b * B + c
            dev = [
                tuple(int(v) for v in row)
                for row in anchors[g][gvalid[g]]
            ]
            host = [(*lft, *t) for lft, t in th.get(c, [])]
            assert dev == host, f"anchor mismatch b={b} sid={c}"
            n_anchors += len(host)
    assert n_anchors > 10 * B  # real cross-target mass at 64 targets


def test_v2_build_and_query_on_one_device_mesh():
    """A DEGENERATE 1-device mesh must trace and run the v2 sharded
    build + probe query (the single-card serving shape).  Regression: the hash-range partition constant
    ((2^24/n_dev) << 8) overflowed uint32 at n_dev=1 — the bounds array
    is empty there, so the wrapped value is never read, but the trace
    died before reaching that fact."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgrtk.parallel import mesh as pmesh

    B, L = 4, 8192
    rng = np.random.default_rng(9)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    seqs = np.stack([base.copy() for _ in range(B)])
    for b in range(B):
        n = rng.binomial(L, 3e-4)
        pos = rng.choice(L, size=n, replace=False)
        seqs[b, pos] = (seqs[b, pos] + rng.integers(1, 4, size=n)) % 4
    lens = np.full(B, L, dtype=np.int32)
    rids = np.arange(B, dtype=np.uint32)

    mesh = pmesh.make_mesh(1)
    axis = mesh.axis_names[0]
    sh = NamedSharding(mesh, P(axis, None))
    sh1 = NamedSharding(mesh, P(axis))
    seqs_d = jax.device_put(jnp.asarray(seqs), sh)
    lens_d = jax.device_put(jnp.asarray(lens), sh1)
    rids_d = jax.device_put(jnp.asarray(rids), sh1)

    cap = 4096
    v2 = pmesh.sharded_index_v2_step(mesh, cap, chunk=512)(
        seqs_d, lens_d, rids_d
    )
    for flag in ("shard_overflow", "route_overflow", "probe_overflow",
                 "compact_overflow"):
        assert not bool(v2[flag]), flag
    n_pairs = int(v2["n_pairs"])
    assert n_pairs > 0

    e2e = pmesh.sharded_query_v2_e2e_step(
        mesh, cap, n_targets=B, slots2=96, M=4, postings_cap=16
    )(seqs_d, lens_d, rids_d, *v2["probe"]["planes"])
    for flag in ("compact_overflow", "route_overflow",
                 "postings_overflow"):
        assert not bool(e2e[flag]), flag
    assert int(e2e["n_hits"]) >= n_pairs  # self-query hits every pair


def test_shard_probe_planes_flags_bucket_overflow():
    """All postings of one key land in ONE 128-slot bucket row; a key
    with > 128 postings (or bucket-sharing keys summing past 128) must
    raise probe_overflow, never drop silently (the 16-device dryrun
    found 12 full buckets with the flag unchecked)."""
    import jax.numpy as jnp

    from pgrtk.parallel import mesh as pmesh

    n = 256
    shard = {
        "k0_hi": jnp.full((n,), jnp.uint32(7)),
        "k0_lo": jnp.full((n,), jnp.uint32(9)),
        "k1_hi": jnp.full((n,), jnp.uint32(11)),
        "k1_lo": jnp.full((n,), jnp.uint32(13)),
        "sid": jnp.zeros((n,), jnp.uint32),
        "bgn": jnp.arange(n, dtype=jnp.uint32),
        "end": jnp.arange(n, dtype=jnp.uint32) + 1,
        "orientation": jnp.zeros((n,), jnp.uint32),
        "valid": jnp.ones((n,), bool),
    }
    _planes, _row, ovf = pmesh._shard_probe_planes(shard, bits=4)
    assert bool(ovf)  # 256 postings of one key > 128-slot bucket row

    # 100 postings fit
    shard2 = {kk: v[:100] for kk, v in shard.items()}
    _planes, _row, ovf2 = pmesh._shard_probe_planes(shard2, bits=4)
    assert not bool(ovf2)


def test_chunk_row_serving_shape_on_mesh():
    """The PRODUCTION serving topology: 64 kb chunk-row queries sharded
    over the mesh against the v2 hash-range index built from the FULL
    target sequences — exact anchor parity per (chunk, target) group
    (the on-chip runs exercise this shape at 1 device; this pins it
    multi-device)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgrtk.core import query as query_mod
    from pgrtk.core.spec import ShmmrSpec
    from pgrtk.ops import query_e2e
    from pgrtk.parallel import mesh as pmesh

    rng = np.random.default_rng(3)
    C, L = 8, 131072
    base = rng.integers(0, 4, size=L, dtype=np.uint8)

    def mutate():
        s = base.copy()
        n = rng.binomial(L, 3e-4)
        pos = rng.choice(L, n, replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, n)) % 4
        return s

    targets = np.stack([mutate() for _ in range(C)])
    mesh = pmesh.make_mesh(8)
    axis = mesh.axis_names[0]
    sh = NamedSharding(mesh, P(axis, None))
    sh1 = NamedSharding(mesh, P(axis))
    t_d = jax.device_put(jnp.asarray(targets), sh)
    tl_d = jax.device_put(jnp.full((C,), L, jnp.int32), sh1)
    tr_d = jax.device_put(jnp.arange(C, dtype=jnp.uint32), sh1)
    v2 = pmesh.sharded_index_v2_step(mesh, 16384, chunk=512)(
        t_d, tl_d, tr_d
    )
    for f in ("shard_overflow", "route_overflow", "probe_overflow",
              "compact_overflow"):
        assert not bool(v2[f]), f

    QC = 2  # 64 kb chunk rows, two per target, sharded over devices
    qch = targets.reshape(C * QC, L // QC)
    BQ, LQ = qch.shape
    q_d = jax.device_put(jnp.asarray(qch), sh)
    ql_d = jax.device_put(jnp.full((BQ,), LQ, jnp.int32), sh1)
    qr_d = jax.device_put(jnp.arange(BQ, dtype=jnp.uint32), sh1)
    e2e = pmesh.sharded_query_v2_e2e_step(
        mesh, 16384, n_targets=C, slots2=192, M=3, postings_cap=32,
    )(q_d, ql_d, qr_d, *v2["probe"]["planes"])
    for f in ("compact_overflow", "route_overflow", "postings_overflow"):
        assert not bool(e2e[f]), f
    anchors = np.asarray(e2e["anchors"])
    gvalid = np.asarray(e2e["gvalid"])

    idx = query_e2e.build_index(targets, n_decoys=0)
    lookup = idx["lookup"]
    spec = ShmmrSpec(80, 56, 4, 64, True)
    BASES = b"ACGT"
    n_anchors = 0
    for b in range(BQ):
        qb = bytes(bytearray(BASES[v] for v in qch[b]))
        raw = query_mod.raw_query_fragment(
            lambda s0, s1: lookup.get((s0, s1), []), qb, spec
        )
        th = query_mod.collect_target_hits(raw)
        for c in range(C):
            g = b * C + c
            dev = [tuple(int(v) for v in row)
                   for row in anchors[g][gvalid[g]]]
            host = [(*lft, *t) for lft, t in th.get(c, [])]
            assert dev == host, (b, c)
            n_anchors += len(host)
    assert n_anchors > 4 * BQ  # real chunk->target anchor mass
