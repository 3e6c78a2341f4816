"""Pipeline regression snapshots.

These goldens were generated by THIS framework (the reference toolchain
cannot run in this environment — there is no Rust toolchain); they guard
future changes against behavioral drift.  The reference-anchored parity
tests live in test_sketch_ref.py (golden .mdb/.midx/.frg produced by the
reference implementation).
"""
import os
import sys

import pytest

import pgrtk
from pgrtk.core.fasta import read_fastx_all

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def test_query_hits_snapshot(test_data_dir, tmp_path):
    from pgrtk.cli import pgr_query

    db = pgrtk.SeqIndexDB()
    db.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))
    q = read_fastx_all(os.path.join(test_data_dir, "test_seqs2.fa.gz"))[:4]
    pgr_query.run_query(db, q, str(tmp_path / "q"), nthreads=1)
    got = "".join(
        open(tmp_path / f"q.{i:03}.hit").read() for i in range(4)
    )
    expect = open(os.path.join(GOLDEN_DIR, "query_hits.txt")).read()
    assert got == expect


def test_sv_pipeline_snapshot(test_data_dir, tmp_path):
    from pgrtk.cli import pgr_get_sv_candidate_regions as sv

    recs = read_fastx_all(
        os.path.join(test_data_dir, "test_agc_seqs.fa")
    )[:3]
    qf = tmp_path / "q3.fa"
    with open(qf, "w") as f:
        for r in recs:
            f.write(f">{r.id.decode()}\n{r.seq.decode()}\n")
    sv.main(
        [
            os.path.join(test_data_dir, "test_agc_ref.fa"),
            str(qf),
            str(tmp_path / "sv"),
        ]
    )
    for name in ("sv.alnmap", "sv.vcf"):
        got = open(tmp_path / name).read()
        expect = open(os.path.join(GOLDEN_DIR, name)).read()
        assert got == expect, name


def test_pbundle_bed_snapshot(test_data_dir, tmp_path):
    from pgrtk.cli import pgr_pbundle_decomp as pbd

    pbd.main(
        [os.path.join(test_data_dir, "test_seqs.fa"), str(tmp_path / "pb")]
    )
    got = open(tmp_path / "pb.bed").read().splitlines()[1:]
    expect = (
        open(os.path.join(GOLDEN_DIR, "pbundle.bed")).read().splitlines()
    )
    assert got == expect


def test_query_hits_snapshot_device_batch(test_data_dir, tmp_path):
    """--batch-device (device sketch + probe) reproduces the host goldens."""
    from pgrtk.cli import pgr_query

    db = pgrtk.SeqIndexDB()
    db.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))
    q = read_fastx_all(os.path.join(test_data_dir, "test_seqs2.fa.gz"))[:4]
    pgr_query.run_query(
        db, q, str(tmp_path / "q"), nthreads=1, batch_device=True
    )
    got = "".join(
        open(tmp_path / f"q.{i:03}.hit").read() for i in range(4)
    )
    expect = open(os.path.join(GOLDEN_DIR, "query_hits.txt")).read()
    assert got == expect
