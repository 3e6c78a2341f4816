"""End-to-end tutorial workflow mirroring the reference's CMRG example
(reference: pgr-tk/examples/generate_gfa_for_CMRG.py): query a pangenome
db with a gene sequence, merge hit regions, extract oriented sub-
sequences, re-index them at a finer sketch, and emit the local MAP-graph
GFA + adjacency list + principal bundles."""
import os

import pgrtk
from pgrtk.core.fasta import read_fastx_all


def test_cmrg_style_workflow(test_data_dir, tmp_path):
    db = pgrtk.SeqIndexDB()
    db.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))

    gene_seq = read_fastx_all(
        os.path.join(test_data_dir, "test_seqs2.fa.gz")
    )[0].seq

    # 1) query the pangenome for the gene locus
    aln_range = pgrtk.query_sdb(
        db, gene_seq, merge_range_tol=int(len(gene_seq) * 0.25)
    )
    assert len(aln_range) > 50  # hits most haplotypes in the test corpus

    # 2) merge hit regions per haplotype, pull oriented sub-sequences
    seq_list = []
    i = 0
    for k in sorted(aln_range):
        ctg_name, source, _len = db.seq_info[k]
        rgns = pgrtk.merge_regions(
            list(aln_range[k]), tol=int(len(gene_seq) * 0.25)
        )
        for b, e, length, orientation, _aln in rgns:
            if length < len(gene_seq) * 0.25:
                continue
            seq = db.get_sub_seq(source, ctg_name, b, e)
            if orientation == 1:
                seq = pgrtk.rc_byte_seq(seq)
            assert len(seq) == e - b
            seq_list.append((f"{ctg_name}_{b}_{e}_{orientation}", seq))
            i += 1
    assert len(seq_list) > 40

    # 3) re-index the extracted locus at a finer sketch
    new_sdb = pgrtk.SeqIndexDB()
    new_sdb.load_from_seq_list(seq_list, "memory", 48, 48, 1, 24)

    # 4) local MAP-graph GFA + index sidecar
    gfa = str(tmp_path / "locus.gfa")
    new_sdb.generate_mapg_gfa(0, gfa)
    lines = open(gfa).read().splitlines()
    assert any(l.startswith("S\t") for l in lines)
    assert any(l.startswith("L\t") for l in lines)
    new_sdb.write_midx_to_text_file(str(tmp_path / "locus.midx"))
    assert len(open(tmp_path / "locus.midx").read().splitlines()) == len(
        seq_list
    )

    # 5) adjacency list + principal bundle decomposition of the locus
    adj = new_sdb.get_smp_adj_list(0)
    assert adj and all(len(rec) == 3 for rec in adj)
    bundles, sid_smps = new_sdb.get_principal_bundle_decomposition(0, 8)
    assert bundles
    smap = dict(sid_smps)
    assert set(smap) == set(range(len(seq_list)))
    # the dominant haplotype projects onto the bundles
    hits = sum(1 for _smp, b in smap[0] if b is not None)
    assert hits > 0
    bids = {b[0] for _smp, b in smap[0] if b is not None}
    assert bids <= set(range(len(bundles)))


def test_map_intervals_in_sdb(test_data_dir):
    db = pgrtk.SeqIndexDB()
    db.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))
    gene_seq = read_fastx_all(
        os.path.join(test_data_dir, "test_seqs2.fa.gz")
    )[0].seq
    interval = (1000, len(gene_seq) - 1000)
    mapped = pgrtk.map_intervals_in_sdb(db, interval, gene_seq)
    assert mapped  # maps onto many haplotypes
    for sid, (orientation, left, right) in mapped.items():
        assert orientation in (0, 1)
        span = abs(right - left)
        # the mapped span stays in the same ballpark as the query span
        assert 0.5 < span / (interval[1] - interval[0]) < 2.0


def test_principle_bundle_bed_for_query(test_data_dir):
    db = pgrtk.SeqIndexDB()
    db.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))[:6]
    seqs = [
        (f"{r.id.decode()}_0_{len(r.seq)}_0", r.seq) for r in recs
    ]
    rows = pgrtk.get_principle_bundle_bed_file_for_query(
        seqs, w=48, k=48, r=1, min_span=24
    )
    assert rows
    for ctg, bgn, end, label in rows:
        assert end > bgn >= 0
        bid, direction, p0, p1 = label.split(":")
        assert direction in ("0", "1")
