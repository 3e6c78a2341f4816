"""gff_db + seq_variants (the reference's two disabled modules,
pgr-db/src/lib.rs:10,14) — validated against the reference's committed
test data: test.gff3.gz and the seq0/seq1 golden alignment strings from
seqs2variants.rs:283-345."""
import numpy as np  # noqa: F401  (conftest pins the CPU backend)

TEST_DATA = "/root/reference/pgr-db/test/test_data"

SEQ0 = open(f"{TEST_DATA}/seq0").read().strip()
SEQ1 = open(f"{TEST_DATA}/seq1").read().strip()


def test_gff_db_load_and_offspring():
    from pgrtk.core.gff_db import GFFDB

    db = GFFDB.from_file(f"{TEST_DATA}/test.gff3.gz")
    assert db.records, "no records parsed"
    assert db.header, "no header lines"
    # the reference's own test queries the FLG gene by Name
    # (gff_db.rs:274-291)
    flg = db.name_to_rec["FLG"]
    assert flg.type_name == "gene"
    offspring = db.get_all_offspring("FLG", recursive=True)
    assert offspring
    # recursive walk must include grandchildren (exons under transcripts)
    types = {r.type_name for r in offspring}
    assert "exon" in types
    # non-recursive returns only direct children (transcripts)
    direct = db.get_all_offspring("FLG", recursive=False)
    assert direct and all(
        r.attributes.get("Parent") == flg.attributes["ID"] for r in direct
    )
    assert len(offspring) > len(direct)
    # unknown feature -> None (reference returns Option::None)
    assert db.get_all_offspring("NOT_A_GENE") is None


def test_gff_db_interval_query_and_json_roundtrip():
    from pgrtk.core.gff_db import GFFDB

    db = GFFDB.from_file(f"{TEST_DATA}/test.gff3.gz")
    flg = db.name_to_rec["FLG"]
    hits = db.query_interval(flg.seqid, flg.bgn, flg.end + 1)
    assert flg in hits
    genes = db.query_interval(flg.seqid, flg.bgn, flg.end + 1, types={"gene"})
    assert all(r.type_name == "gene" for r in genes) and flg in genes

    db2 = GFFDB.load_json(db.dump_json())
    assert len(db2.records) == len(db.records)
    assert db2.name_to_rec["FLG"].bgn == flg.bgn
    off1 = [r.to_line() for r in db.get_all_offspring("FLG")]
    off2 = [r.to_line() for r in db2.get_all_offspring("FLG")]
    assert off1 == off2


def test_aln_map_matches_reference_golden():
    """Reference-anchored golden: the exact aligned display strings the
    reference asserts in seqs2variants.rs:299-301."""
    from pgrtk.core import seq_variants as sv

    segs = sv.get_aln_segments(0, SEQ0, 1, SEQ1)
    am = sv.get_aln_map(segs, SEQ0, SEQ1)
    assert am.ref_a_seq == (
        b"TCCATTCCCACCAGCAGTGTGTGAAAGTCTGGTACTGGTTCAGCCTGCCGTACTTTAATG"
        b"ATTATTGGTGTCACTCTTTCAAGTAACTTGTTGGTAATA--------AGAAGTCAATTA"
    )
    assert am.aln_seq == (
        b"|||||||||||||||||||||||||           ||||||||||||||||||||||||"
        b"||||||||||.||||||||||||||||||||||||||||        ||||||||||||"
    )
    assert am.tgt_a_seq == (
        b"TCCATTCCCACCAGCAGTGTGTGAA-----------GGTTCAGCCTGCCGTACTTTAATG"
        b"ATTATTGGTGACACTCTTTCAAGTAACTTGTTGGTAATATTTATCTAAGAAGTCAATTA"
    )


def test_aln_fragments_match_reference_golden():
    """The windowed fragments the reference asserts in
    seqs2variants.rs:304-344, including the deletion pmap pinning quirk
    and the pure-match window at ref position 80."""
    from pgrtk.core import seq_variants as sv

    segs = sv.get_aln_segments(0, SEQ0, 1, SEQ1)
    am = sv.get_aln_map(segs, SEQ0, SEQ1)
    nm = [s for s in segs if s.t != sv.AlnSegType.Match]

    out = sv.get_aln_fragment(nm[0].ref_loc, am, len(SEQ0))
    assert out == (
        b"GTGAAAGTCTGGTACTGGTTC",
        b"|||||           |||||",
        b"GTGAA-----------GGTTC",
    )
    out = sv.get_aln_fragment(nm[1].ref_loc, am, len(SEQ0))
    assert out == (b"TGGTGTCACTC", b"|||||.|||||", b"TGGTGACACTC")
    out = sv.get_aln_fragment(nm[2].ref_loc, am, len(SEQ0))
    assert out == (
        b"TAATA--------AGAAG",
        b"|||||        |||||",
        b"TAATATTTATCTAAGAAG",
    )
    out = sv.get_aln_fragment(sv.SeqLocus(0, 80, 1), am, len(SEQ0))
    assert out == (b"CTTTCAAGTAA", b"|||||||||||", b"CTTTCAAGTAA")


def test_cigar_segments_roundtrip():
    from pgrtk.core import seq_variants as sv

    score, cigar = sv.get_cigar(SEQ0, SEQ1)
    assert score > 0
    # cigar columns reconstruct both sequence lengths
    n_ref = sum(1 for c in cigar if chr(c) in "MXD")
    n_tgt = sum(1 for c in cigar if chr(c) in "MXI")
    assert n_ref == len(SEQ0)
    assert n_tgt == len(SEQ1)
    # segments partition both sequences
    segs = sv.get_aln_segments(0, SEQ0, 1, SEQ1)
    assert sum(s.ref_loc.len for s in segs) == len(SEQ0)
    assert sum(s.tgt_loc.len for s in segs) == len(SEQ1)


def test_gff_parent_cycle_ends_in_python_control():
    """A crafted Parent cycle (A->B->A) must not hang get_all_offspring:
    the recursive walk hits Python's recursion limit and raises
    RecursionError (the reference's recursive walk, gff_db.rs:215-251,
    would overflow the stack on the same input)."""
    import pytest

    from pgrtk.core.gff_db import GFFDB

    db = GFFDB.from_list_of_fields([
        ["c", "x", "gene", "1", "100", ".", "+", ".", "ID=A;Parent=B"],
        ["c", "x", "gene", "1", "100", ".", "+", ".", "ID=B;Parent=A"],
    ])
    with pytest.raises(RecursionError):
        db.get_all_offspring("A")
