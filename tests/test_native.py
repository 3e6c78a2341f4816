"""Native library vs Python arbiter cross-validation."""
import os
import random

import numpy as np
import pytest

from pgrtk.core import aln_ref, fragcomp, sketch_ref
from pgrtk.core.fasta import read_fastx_all
from pgrtk.core.spec import ShmmrSpec
from pgrtk.native import api as native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable"
)


def _mutate(seq: bytes, rng: random.Random, n_sub=5, n_ins=3, n_del=3) -> bytes:
    s = bytearray(seq)
    bases = b"ACGT"
    for _ in range(n_sub):
        i = rng.randrange(len(s))
        s[i] = rng.choice(bases)
    for _ in range(n_ins):
        i = rng.randrange(len(s))
        s.insert(i, rng.choice(bases))
    for _ in range(n_del):
        i = rng.randrange(len(s))
        del s[i]
    return bytes(s)


def test_native_sketch_matches_reference(test_data_dir):
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))[:8]
    for spec in (ShmmrSpec(sketch=False), ShmmrSpec(sketch=True),
                 ShmmrSpec(w=48, k=56, r=4, min_span=12, sketch=False)):
        for i, rec in enumerate(recs):
            nat = native.sequence_to_shmmrs(i, rec.seq, spec)
            ref = sketch_ref.sequence_to_shmmrs(i, rec.seq, spec)
            assert nat == ref


def test_native_batch_sketch(test_data_dir):
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))
    spec = ShmmrSpec(sketch=False)
    batch = native.batch_sequence_to_shmmrs(
        [(i, r.seq) for i, r in enumerate(recs)], spec
    )
    for i in (0, 7, 31, len(recs) - 1):
        assert batch[i] == native.sequence_to_shmmrs(i, recs[i].seq, spec)


def test_match_reads_delta_roundtrip():
    """Delta encode/decode reproduces the mutated fragment exactly
    (reference test: pgr-db/src/lib.rs:107-164)."""
    rng = random.Random(7)
    bases = b"ACGT"
    for trial in range(20):
        base = bytes(rng.choice(bases) for _ in range(2000))
        frg = _mutate(base, rng)
        m = native.match_reads(base, frg, get_delta=True, tol=0.1, bandwidth=32)
        assert m is not None
        segs = fragcomp.deltas_to_aln_segs(
            m["deltas"], m["end0"], m["end1"], base, frg
        )
        assert fragcomp.reconstruct_seq_from_aln_segs(base, segs) == frg


def test_match_reads_identical():
    seq = b"ACGT" * 500
    m = native.match_reads(seq, seq, get_delta=True)
    assert m is not None
    assert m["dist"] == 0
    segs = fragcomp.deltas_to_aln_segs(m["deltas"], m["end0"], m["end1"], seq, seq)
    assert segs == [(fragcomp.FULL_MATCH,)]


def _load_test_hits(test_data_dir):
    hits = []
    with open(os.path.join(test_data_dir, "test_hits")) as f:
        for line in f:
            v = [int(t) for t in line.split()]
            assert len(v) == 6
            hits.append(((v[0], v[1], v[2]), (v[3], v[4], v[5])))
    return hits


def test_sparse_aln_native_vs_reference(test_data_dir):
    """Chain DP on the reference's committed anchor corpus
    (reference test: pgr-db/src/aln.rs:455-485)."""
    hits = _load_test_hits(test_data_dir)
    ref_out = aln_ref.sparse_aln(list(hits), 8, 0.5, None, False)

    arr = np.asarray(
        [[*h[0], *h[1]] for h in hits], dtype=np.uint32
    )
    nat_out = native.sparse_aln(arr, 8, 0.5, None, False)

    assert len(nat_out) == len(ref_out)
    for (ns, ntrack), (rs, rtrack) in zip(nat_out, ref_out):
        assert ns == pytest.approx(rs, rel=1e-6)
        nt = [((int(a), int(b), int(c)), (int(d), int(e), int(f)))
              for a, b, c, d, e, f in ntrack]
        assert nt == rtrack


def test_sparse_aln_oriented_and_gap(test_data_dir):
    hits = _load_test_hits(test_data_dir)[:500]
    arr = np.asarray([[*h[0], *h[1]] for h in hits], dtype=np.uint32)
    for oriented in (False, True):
        for max_gap in (None, 1000):
            ref_out = aln_ref.sparse_aln(list(hits), 8, 0.5, max_gap, oriented)
            nat_out = native.sparse_aln(arr, 8, 0.5, max_gap, oriented)
            assert len(nat_out) == len(ref_out)
            for (ns, ntrack), (rs, rtrack) in zip(nat_out, ref_out):
                assert ns == pytest.approx(rs, rel=1e-6)
                assert len(ntrack) == len(rtrack)
