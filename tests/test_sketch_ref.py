"""Exactness tests for the scalar reference sketcher.

Golden data: pgr-db/test/test_data/test_seqs_frag.mdb was generated by the
reference implementation via load_from_fastx("test_seqs.fa") with defaults
(w=80, k=56, r=4, min_span=64, sketch=False) — see gen_frag_db.py there.
"""
import os

import pytest

from pgrtk.core import mdb, sketch_ref
from pgrtk.core.fasta import read_fastx_all, reverse_complement
from pgrtk.core.seqdb import CompactSeqDB
from pgrtk.core.spec import ShmmrSpec

SPEC = ShmmrSpec(w=80, k=56, r=4, min_span=64, sketch=False)


def test_u64hash_known_values():
    # independent evaluation of the Wang hash recurrence on Python ints
    M = (1 << 64) - 1

    def slow(key):
        key = ((key << 21) - key - 1) & M
        key ^= key >> 24
        key = (key * 265) & M
        key ^= key >> 14
        key = (key * 21) & M
        key ^= key >> 28
        key = (key + (key << 31)) & M
        return key

    for v in [0, 1, 2, 1234567890123456789, (1 << 56) - 1, (1 << 64) - 1]:
        assert sketch_ref.u64hash(v) == slow(v)


def test_strand_symmetry(test_data_dir):
    """Shimmers of a sequence == reversed shimmers of its revcomp
    (reference test: pgr-db/src/lib.rs:166-180)."""
    recs = read_fastx_all(os.path.join(test_data_dir, "test_rev.fa"))
    assert recs
    for rec in recs:
        fwd = sketch_ref.sequence_to_shmmrs(0, rec.seq, SPEC)
        rev = sketch_ref.sequence_to_shmmrs(0, reverse_complement(rec.seq), SPEC)
        L = len(rec.seq)
        fwd_hashes = [x >> 8 for x, _ in fwd]
        rev_hashes = [x >> 8 for x, _ in rev][::-1]
        assert fwd_hashes == rev_hashes
        # positions mirror: rev pos p maps to L-1-(p-k+1)... check end-points
        fwd_pos = [(y & 0xFFFFFFFF) >> 1 for _, y in fwd]
        rev_pos = [(y & 0xFFFFFFFF) >> 1 for _, y in rev][::-1]
        k = SPEC.k
        assert all(fp + rp == L + k - 2 for fp, rp in zip(fwd_pos, rev_pos))


def test_golden_mdb_parity(test_data_dir):
    """Index built from test_seqs.fa matches the reference-built .mdb
    signature-for-signature."""
    db = CompactSeqDB(SPEC)
    db.load_from_fastx(
        os.path.join(test_data_dir, "test_seqs.fa"), store_frags=False
    )
    spec_g, golden = mdb.read_mdb(
        os.path.join(test_data_dir, "test_seqs_frag.mdb")
    )
    assert spec_g == SPEC
    assert set(golden.keys()) == set(db.frag_map.keys())
    for key, sigs in golden.items():
        assert [tuple(s) for s in sigs] == db.frag_map[key], key


def test_golden_midx_parity(test_data_dir, tmp_path):
    db = CompactSeqDB(SPEC)
    db.load_from_fastx(
        os.path.join(test_data_dir, "test_seqs.fa"), store_frags=False
    )
    ours = [(s.id, s.len, s.name) for s in db.seqs]
    golden = [
        (sid, ln, name)
        for sid, ln, name, _src in mdb.read_midx(
            os.path.join(test_data_dir, "test_seqs_frag.midx")
        )
    ]
    assert ours == golden


def test_mdb_roundtrip(test_data_dir, tmp_path):
    spec, frag_map = mdb.read_mdb(
        os.path.join(test_data_dir, "test_seqs_frag.mdb")
    )
    out = str(tmp_path / "rt.mdb")
    mdb.write_mdb(spec, frag_map, out)
    spec2, frag_map2 = mdb.read_mdb(out)
    assert spec2 == spec
    assert frag_map2 == frag_map


def test_sketch_mode2_threshold(test_data_dir):
    recs = read_fastx_all(os.path.join(test_data_dir, "test_rev.fa"))
    spec2 = ShmmrSpec(w=80, k=56, r=4, min_span=64, sketch=True)
    thr = ((1 << 64) - 1) >> 4 >> spec2.r
    for rec in recs:
        mers = sketch_ref.sequence_to_shmmrs(0, rec.seq, spec2)
        assert all((x >> 8) < thr for x, _ in mers)


def test_mer_stream_strand_symmetry(test_data_dir):
    """The raw k-mer hash stream is strand-canonical: for windows present
    in both directions (the reference skips the very first k-mer: pos < k,
    shmmrutils.rs:481-484) forward and reverse-complement hashes mirror."""
    recs = read_fastx_all(os.path.join(test_data_dir, "test_rev.fa"))
    k = 56
    for rec in recs:
        L = len(rec.seq)
        fwd = {
            pos: h for pos, _x, _y, h in sketch_ref._mer_stream(0, rec.seq, k)
        }
        rev = {
            L + k - 2 - pos: h
            for pos, _x, _y, h in sketch_ref._mer_stream(
                0, reverse_complement(rec.seq), k
            )
        }
        common = set(fwd) & set(rev)
        assert len(common) >= L - k - 2
        assert all(fwd[p] == rev[p] for p in common)


def test_subseq_reconstruction(test_data_dir):
    """Random sub-range access vs full reconstruction
    (reference test: pgr-db/src/lib.rs:365-462)."""
    import random

    db = CompactSeqDB(SPEC)
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))
    db.load_seqs([(r.source, r.id.decode(), r.seq) for r in recs[:5]])
    rng = random.Random(42)
    for sid in range(5):
        full = db.get_seq_by_id(sid)
        assert full == recs[sid].seq
        L = len(full)
        for _ in range(10):
            b = rng.randrange(0, L - 1)
            e = rng.randrange(b + 1, L)
            assert db.get_sub_seq_by_id(sid, b, e) == full[b:e]


def test_device_backend_dispatch_parity(test_data_dir, monkeypatch):
    """PGRTK_SKETCH_BACKEND=device routes batch sketching through the
    device kernels and matches the host backends in both modes."""
    from pgrtk.core import sketch as SK
    from pgrtk.core.fasta import read_fastx_all
    from pgrtk.core.spec import ShmmrSpec

    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))[:6]
    pairs = [(i, r.seq) for i, r in enumerate(recs)]
    for spec in (ShmmrSpec(sketch=True), ShmmrSpec(sketch=False)):
        host = SK.batch_sequence_to_shmmrs(pairs, spec)
        monkeypatch.setenv("PGRTK_SKETCH_BACKEND", "device")
        dev = SK.batch_sequence_to_shmmrs(pairs, spec)
        monkeypatch.delenv("PGRTK_SKETCH_BACKEND")
        assert [
            [(int(a), int(b)) for a, b in h] for h in host
        ] == [[(int(a), int(b)) for a, b in d] for d in dev]
