"""Edge-content property tests: sequences shorter than k, all-N runs,
lowercase, interleaved ambiguity — through the MEMORY build, the FRG
disk cycle (write -> reload -> reconstruct), query, and the
index-derived smps path.  The reference handles these by construction
(registers skip non-ACGT, short seqs yield no mers, seq_db.rs:360-418);
every byte must survive our storage round trips too."""
import os

import pytest

import pgrtk

RECS = [
    ("tiny", b"ACGT"),                 # << k: no mers, no pairs
    ("ns", b"N" * 500),                # all ambiguous
    ("lower", b"acgtacgt" * 200),      # lowercase bases
    ("mixed", b"ACGTN" * 400),         # interleaved Ns
    ("one", b"A"),                     # single base
    ("tandem8", b"ACGTTGCA" * 4000),   # perfect short-unit tandem:
                                       # sketch-INVISIBLE (equal
                                       # adjacent hashes die to the
                                       # distinctness rule,
                                       # shmmrutils.rs:545-548)
]


def test_memory_build_reconstructs_edge_content():
    db = pgrtk.SeqIndexDB()
    db.load_from_seq_list(list(RECS), w=80, k=56, r=4, min_span=64)
    assert len(db.seq_info) == len(RECS)
    want = dict(RECS)
    for sid, (name, _src, ln) in sorted(db.seq_info.items()):
        assert ln == len(want[name])
        assert db.get_seq_by_id(sid) == want[name]


def test_frg_disk_cycle_and_smps_on_edge_content(tmp_path):
    fa = tmp_path / "edge.fa"
    with open(fa, "w") as f:
        for n, s in RECS:
            f.write(f">{n}\n{s.decode()}\n")
    db = pgrtk.SeqIndexDB()
    db.load_from_fastx(str(fa))
    pref = str(tmp_path / "edge")
    db.write_frag_and_index_files(pref)

    db2 = pgrtk.SeqIndexDB()
    db2.load_from_frg_index(pref)
    want = dict(RECS)
    for sid, (name, _src, _ln) in sorted(db2.seq_info.items()):
        assert db2.get_seq_by_id(sid) == want[name]
        # index-derived smps == re-sketch, even with zero pairs
        assert db2.get_smps_by_id(sid) == db2.get_smps(
            db2.get_seq_by_id(sid)
        )
    # the perfect 8-base tandem leaves NO index keys (sketch
    # invisibility) -> self-query legitimately returns nothing
    assert db2.query_fragment_to_hps(want["tandem8"], 0.025) == []
    # queries against the edge db stay in python control
    assert db2.query_fragment_to_hps(b"ACGT", 0.025) == []
