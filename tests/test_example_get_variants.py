"""The reference's second shipped example workflow
(pgr-tk/examples/get_variants.py): align every query contig to a
pangenome db via query_sdb, reduce each hit's anchor chain to strictly
monotonic target/query segments, and call variants per segment with
get_variant_segments.  The tutorial-workflow test covers the first
example (generate_gfa_for_CMRG.py); this covers the second — same API
surface (query_sdb, get_shmmr_spec, get_seq_by_id, u8_to_string, rc,
get_variant_segments), planted SNPs recovered at their coordinates.
"""
import os

import numpy as np
import pytest

import pgrtk
from pgrtk.core.fasta import read_fastx_all


def _monotonic_segments(aln, orientation):
    """Reduce one hit's anchor list to strictly increasing
    (target, query) segment pairs, as the example's filter_aln /
    filter_aln_rev do: walk anchors (reversed for orientation 1), keep
    those whose target interval starts at/after the previous end and
    whose strand flag matches the hit orientation, and chain segment
    boundaries so consecutive segments abut."""
    segs = list(aln)
    if orientation == 1:
        segs = segs[::-1]
    first = segs[0]
    t_s, t_e = first[1][0], first[1][1]
    q_s, q_e = first[0][0], first[0][1]
    out = [((t_s, t_e), (q_s, q_e))]
    for q, t in segs:
        if t[1] < t[0]:
            continue
        same = q[-1] == t[-1]
        if (orientation == 0 and not same) or (orientation == 1 and same):
            continue
        if t[0] >= t_e:
            t_s, t_e = t_e, t[1]
            if orientation == 0:
                q_s, q_e = q_e, q[1]
            else:
                q_s, q_e = q[0], q_s
            if t_s == t_e:
                continue
            out.append(((t_s, t_e), (q_s, q_e)))
    return out


def test_get_variants_example_workflow(tmp_path):
    rng = np.random.default_rng(21)
    bases = np.frombuffer(b"ACGT", np.uint8)
    L = 60_000
    ref = rng.integers(0, 4, size=L, dtype=np.uint8)
    fa = tmp_path / "target.fa"
    with open(fa, "w") as f:
        f.write(f">t0\n{bases[ref].tobytes().decode()}\n")

    target_sdb = pgrtk.SeqIndexDB()
    target_sdb.load_from_fastx(str(fa), w=80, k=56, r=4, min_span=64)

    # query: the target with three planted SNPs, away from the ends
    snp_pos = [15_000, 30_000, 45_000]
    q = ref.copy()
    for p in snp_pos:
        q[p] = (q[p] + 1) % 4
    query_seq = bases[q].tobytes()

    res = pgrtk.query_sdb(
        target_sdb, query_seq,
        merge_range_tol=0, gap_penalty_factor=0.001,
        max_query_count=1, max_target_count=1,
    )
    assert res, "query produced no hits"
    _w, kmer_size, _r, _m, _s = target_sdb.get_shmmr_spec()

    found = []
    for sid, alns in res.items():
        ref_seq = target_sdb.get_seq_by_id(sid)
        for aln_rec in alns:
            ts, te, _tl, orientation = aln_rec[:-1]
            for (t_s, t_e), (q_s, q_e) in _monotonic_segments(
                aln_rec[-1], orientation
            ):
                t_s -= kmer_size
                q_s -= kmer_size
                s0 = pgrtk.u8_to_string(ref_seq[t_s:t_e])
                s1 = pgrtk.u8_to_string(query_seq[q_s:q_e])
                if orientation == 1:
                    s1 = pgrtk.rc(s1)
                if not s0 or not s1 or abs(len(s0) - len(s1)) > 256:
                    continue
                diff = pgrtk.get_variant_segments(
                    s0, s1,
                    max_wf_length=min(64, len(s0), len(s1)),
                    max_diff_percent=1,
                )
                if diff is None:
                    continue
                for d in diff[0]:
                    found.append((int(d[0]) + t_s, d[3], d[4]))

    # every planted SNP is recovered as a 1-base substitution at its
    # reference coordinate (WFA left-alignment keeps SNPs in place)
    positions = {p for p, *_ in found}
    for p in snp_pos:
        assert any(abs(p - fp) <= 1 for fp in positions), (p, sorted(positions))
    # and nothing else was called
    assert len(found) <= len(snp_pos) + 2, found
