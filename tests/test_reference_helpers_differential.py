"""DIFFERENTIAL parity: execute the reference's OWN pure-Python helper
layer (pgr-tk/pgrtk/__init__.py, loaded from /root/reference at test
time — never copied into this repo) against OUR SeqIndexDB objects, and
compare its outputs to our reimplementations.

This is the strongest parity evidence available without the Rust
toolchain: the reference helpers only need a `pgrtk` module exposing
SeqIndexDB + a couple of callables, and our API is PyO3-compatible, so
the reference's exact code paths (region merging, orientation loops,
bundle grouping, diffusion entropy, the full bundle-BED workflow) run
unmodified and must agree with ours bit-for-bit.
"""
import os
import sys
import types

import numpy as np
import pytest

import pgrtk

REF_HELPERS = "/root/reference/pgr-tk/pgrtk/__init__.py"


@pytest.fixture(scope="module")
def ref():
    """The reference helper module, exec'd with a pgrtk shim backed by
    pgrtk (the native-extension import line is dropped; everything
    else runs verbatim)."""
    src = open(REF_HELPERS).read()
    src = src.replace("from .pgrtk import *", "")
    shim = types.ModuleType("pgrtk")
    shim.pgr_lib_version = lambda: "pgrtk-shim"
    shim.SeqIndexDB = pgrtk.SeqIndexDB
    mod = types.ModuleType("ref_pgrtk")
    old = sys.modules.get("pgrtk")
    sys.modules["pgrtk"] = shim
    try:
        exec(compile(src, REF_HELPERS, "exec"), mod.__dict__)
    finally:
        if old is not None:
            sys.modules["pgrtk"] = old
        else:
            sys.modules.pop("pgrtk", None)
    # the bed-file workflow calls pgrtk.group_smps_by_principle_bundle_id
    shim.group_smps_by_principle_bundle_id = (
        mod.group_smps_by_principle_bundle_id
    )
    return mod


@pytest.fixture(scope="module")
def db(test_data_dir):
    d = pgrtk.SeqIndexDB()
    d.load_from_fastx(os.path.join(test_data_dir, "test_seqs.fa"))
    return d


def test_byte_helpers_match(ref):
    rng = np.random.default_rng(0)
    seq = bytes(rng.choice(
        np.frombuffer(b"ACGTNacgtn", np.uint8), 500
    ).tolist())
    # the reference's pure-python rc helpers return LISTS of ints; ours
    # return bytes (same content, the pragmatic drop-in choice — bytes
    # slice/iterate identically and feed every downstream API)
    assert bytes(ref.rc_byte_seq(seq)) == pgrtk.rc_byte_seq(seq)
    assert bytes(ref.rc_u8_seq(list(seq))) == pgrtk.rc_u8_seq(seq)
    s = seq.decode()
    assert ref.rc(s) == pgrtk.rc(s)
    assert bytes(ref.string_to_u8(s)) == pgrtk.string_to_u8(s)
    assert ref.u8_to_string(seq) == pgrtk.u8_to_string(seq)


def test_merge_regions_matches_on_random_inputs(ref):
    rng = np.random.default_rng(1)
    for trial in range(40):
        n = int(rng.integers(1, 12))
        rgns = []
        for _ in range(n):
            b = int(rng.integers(0, 100_000))
            e = b + int(rng.integers(1, 30_000))
            rgns.append(
                (b, e, e - b, int(rng.integers(0, 2)),
                 [("aln", b, e)])
            )
        tol = int(rng.integers(1, 20_000))
        # deep copies per call: the reference MUTATES input inner aln
        # lists in place (`fwd_rgns[-1][4] += r[4]` aliases them) and
        # sorts the input list; sharing inner lists between the two
        # calls would cross-pollute the comparison
        import copy

        theirs = ref.merge_regions(copy.deepcopy(rgns), tol=tol)
        ours = pgrtk.merge_regions(copy.deepcopy(rgns), tol=tol)
        assert [list(map(list, [t]))[0] for t in theirs] == \
            [list(map(list, [o]))[0] for o in ours], (trial, rgns, tol)


def test_query_sdb_reference_code_on_our_db(ref, db, test_data_dir):
    from pgrtk.core.fasta import read_fastx_all

    q = read_fastx_all(
        os.path.join(test_data_dir, "test_seqs2.fa.gz")
    )[0].seq
    theirs = ref.query_sdb(db, q, merge_range_tol=100000)
    ours = pgrtk.query_sdb(db, q, merge_range_tol=100000)
    assert set(theirs) == set(ours)
    for sid in theirs:
        assert theirs[sid] == ours[sid], sid
    assert theirs  # real hits flowed through both


def test_map_intervals_reference_code_on_our_db(ref, db, test_data_dir):
    from pgrtk.core.fasta import read_fastx_all

    q = read_fastx_all(
        os.path.join(test_data_dir, "test_seqs2.fa.gz")
    )[0].seq
    interval = (len(q) // 4, len(q) // 2)
    theirs = ref.map_intervals_in_sdb(db, interval, q)
    ours = pgrtk.map_intervals_in_sdb(db, interval, q)
    assert theirs == ours
    assert theirs[0]  # mapped to at least one target


def test_group_smps_by_principle_bundle_id_matches(ref, db):
    pb, sid_smps = db.get_principal_bundle_decomposition(0, 8)
    checked = 0
    for _sid, smps in sid_smps[:8]:
        theirs = ref.group_smps_by_principle_bundle_id(smps, 2500, 5000)
        ours = pgrtk.group_smps_by_principle_bundle_id(
            smps, 2500, 5000
        )
        assert theirs == ours
        checked += sum(len(p) for p in theirs)
    assert checked > 0


def test_diffusion_entropy_matches(ref, db, tmp_path):
    gfa = str(tmp_path / "g.gfa")
    db.generate_mapg_gfa(2, gfa)
    theirs = ref.compute_graph_diffusion_entropy(gfa)
    ours = pgrtk.compute_graph_diffusion_entropy(gfa)
    assert theirs == ours


def test_principle_bundle_bed_workflow_matches(ref, db):
    # the workflow expects query_sdb-style names carrying the
    # `..._bgn_end_ori` suffix it parses back to coordinates
    seqs = [
        (f"{db.seq_info[sid][0]}_1000_41000_0", db.get_seq_by_id(sid))
        for sid in range(6)
    ]
    theirs = ref.get_principle_bundle_bed_file_for_query(list(seqs))
    ours = pgrtk.get_principle_bundle_bed_file_for_query(list(seqs))
    assert theirs == ours
    assert theirs  # non-empty bed records
