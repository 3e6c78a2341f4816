"""PyO3-surface signature parity, pinned.

The reference's Python surface is defined by the #[pyfunction]/#[pyo3]
signature attributes in pgr-tk/src/lib.rs and the pure-Python helpers
in pgr-tk/pgrtk/__init__.py.  Notebook code calls these with keywords
and relies on the defaults, so name/order/default parity IS behavior
(round 4 caught three real breaks this way: a different function
exported as get_variant_segments, aggregate-shaped
get_shmmr_pair_count/source_count, and wrong load_from_seq_list
defaults).  Each entry cites the reference signature's line.
"""
import inspect
import re

import pgrtk as p

# name -> (expected signature, reference file:line of the signature)
FREE_FUNCTIONS = {
    "sparse_aln": (
        "(sp_hits, max_span, penalty, max_gap=None, orientated=False)",
        "lib.rs:1538",
    ),
    "get_shmmr_pairs_from_seq": (
        "(seq, w=80, k=56, r=4, min_span=16, padding=False)",
        "lib.rs:1581",
    ),
    "get_shmmr_dots": (
        "(seq0, seq1, w=80, k=56, r=4, min_span=16)",
        "lib.rs:1649",
    ),
    "wfa_aln_pair_map": ("(aln_target_str, aln_query_str)", "lib.rs:1725"),
    "get_wfa_aln_pair_map": (
        "(target_str, query_str, max_wf_length=None, mismatch_penalty=4,"
        " open_penalty=3, extension_penalty=1, max_diff_percent=0.02)",
        "lib.rs:1736",
    ),
    "get_variants_from_aln_pair_map": (
        "(aln_pairs, target_str, query_str)",
        "lib.rs:1780",
    ),
    "get_variant_segments": (
        "(target_str, query_str, max_wf_length=None, mismatch_penalty=4,"
        " open_penalty=3, extension_penalty=1, max_diff_percent=0.05)",
        "lib.rs:1795",
    ),
    "naive_dbg_consensus": ("(seqs, kmer_size=33, min_cov=2)", "lib.rs:1857"),
    "shmmr_dbg_consensus": (
        "(seqs, w=33, k=33, r=1, min_span=0)",
        "lib.rs:1887",
    ),
    "guided_shmmr_dbg_consensus": (
        "(seqs, w=33, k=33, r=1, min_span=0, min_cov=2)",
        "lib.rs:1929",
    ),
    "shmmr_sparse_aln_consensus": (
        "(seqs, w=33, k=33, r=1, min_span=0, min_cov=2)",
        "lib.rs:1969",
    ),
    # pure-Python helpers (pgr-tk/pgrtk/__init__.py)
    "query_sdb": (
        "(seq_index_db, query_seq, gap_penalty_factor=0.25,"
        " merge_range_tol=12, max_count=128, max_query_count=128,"
        " max_target_count=128, max_aln_span=8)",
        "pgrtk/__init__.py:130",
    ),
    "map_intervals_in_sdb": (
        "(seq_index_db, interval, query_seq, gap_penalty_factor=0.001,"
        " max_count=32, max_query_count=32, max_target_count=32,"
        " max_aln_span=8)",
        "pgrtk/__init__.py:224",
    ),
    "merge_regions": ("(rgns, tol=1000)", "pgrtk/__init__.py:270"),
    "compute_graph_diffusion_entropy": (
        "(gfa_fn, max_nodes=6000)",
        "pgrtk/__init__.py:330",
    ),
    "group_smps_by_principle_bundle_id": (
        "(smps, len_cutoff=2500, merge_length=5000)",
        "pgrtk/__init__.py:391",
    ),
    "get_principle_bundle_bed_file_for_query": (
        "(seqs, w=64, k=56, r=4, min_span=32, min_cov=2,"
        " min_branch_length=8)",
        "pgrtk/__init__.py:470",
    ),
}

METHODS = {
    "load_from_fastx": (
        "(filepath, w=80, k=56, r=4, min_span=64)",
        "lib.rs:142",
    ),
    "load_from_seq_list": (
        "(seq_list, source='Memory', w=80, k=56, r=4, min_span=8)",
        "lib.rs:196",
    ),
    "get_smp_adj_list": ("(min_count, keeps=None)", "lib.rs:893"),
    "get_principal_bundles": (
        "(min_count, path_len_cutoff, keeps=None)",
        "lib.rs:1002",
    ),
    "get_principal_bundle_decomposition": (
        "(min_count, path_len_cutoff, keeps=None)",
        "lib.rs:1066",
    ),
    "get_principal_bundle_projection": (
        "(min_count, path_len_cutoff, sequence, keeps=None)",
        "lib.rs:1128",
    ),
    "generate_mapg_gfa": (
        "(min_count, filepath, method='from_fragmap', keeps=None)",
        "lib.rs:1304",
    ),
    "generate_principal_mapg_gfa": (
        "(min_count, path_len_cutoff, filepath, keeps=None)",
        "lib.rs:1357",
    ),
    "shmmr_sparse_aln_consensus": ("(sids, min_cov)", "lib.rs:1386"),
    "get_shmmr_pair_count": ("(shmmr_pair)", "lib.rs:635"),
    "get_shmmr_pair_source_count": (
        "(shmmr_pair, max_unique_count)",
        "lib.rs:668",
    ),
    "get_sub_seq": (
        "(sample_name, ctg_name, bgn, end)",
        "lib.rs:809",
    ),
    "get_sub_seq_by_id": ("(sid, bgn, end)", "lib.rs:838"),
    "get_seq": ("(sample_name, ctg_name)", "lib.rs:857"),
    "get_seq_by_id": ("(sid)", "lib.rs:876"),
}


def _norm(sig: str) -> str:
    sig = re.sub(r":\s*'[^']*'", "", sig)           # type annotations
    sig = re.sub(r"\s*->.*$", "", sig)              # return annotation
    sig = sig.replace('"', "'").replace(" ", "")
    sig = sig.replace("(self,", "(").replace("(self)", "()")
    return sig


def test_free_function_signatures_match_pyo3():
    for name, (want, where) in FREE_FUNCTIONS.items():
        fn = getattr(p, name, None)
        assert fn is not None, f"{name} missing from pgrtk ({where})"
        got = _norm(str(inspect.signature(fn)))
        assert got == _norm(want), (
            f"{name} ({where}): expected {want}, got"
            f" {inspect.signature(fn)}"
        )


def test_seqindexdb_method_signatures_match_pyo3():
    for name, (want, where) in METHODS.items():
        m = getattr(p.SeqIndexDB, name, None)
        assert m is not None, f"SeqIndexDB.{name} missing ({where})"
        got = _norm(str(inspect.signature(m)))
        assert got == _norm("(" + want.strip("()") + ")"), (
            f"SeqIndexDB.{name} ({where}): expected {want}, got"
            f" {inspect.signature(m)}"
        )


def test_agcfile_instance_surface():
    """AGCFile is a factory here (sniffs .agc vs .pga); its instances
    must carry the reference pyclass surface: get_sub_seq, get_seq, and
    the ctg_lens getter (lib.rs:1439-1523)."""
    f = p.AGCFile("/root/reference/pgr-db/test/test_data/test.agc")
    assert callable(f.get_sub_seq) and callable(f.get_seq)
    assert hasattr(f, "ctg_lens")
