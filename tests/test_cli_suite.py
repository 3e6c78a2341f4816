"""Smoke tests for the CLI tools not covered by the golden/regression
suites: every tool runs end-to-end on the shared test data and produces
structurally sane output."""
import json
import os

import pytest

import pgrtk
from pgrtk.core.fasta import read_fastx_all


@pytest.fixture(scope="module")
def sv_outputs(test_data_dir, tmp_path_factory):
    """One SV-candidate pipeline run shared by the dependent tools."""
    from pgrtk.cli import pgr_get_sv_candidate_regions as sv

    td = tmp_path_factory.mktemp("sv")
    recs = read_fastx_all(os.path.join(test_data_dir, "test_agc_seqs.fa"))[:3]
    qf = td / "q3.fa"
    with open(qf, "w") as f:
        for r in recs:
            f.write(f">{r.id.decode()}\n{r.seq.decode()}\n")
    sv.main(
        [
            os.path.join(test_data_dir, "test_agc_ref.fa"),
            str(qf),
            str(td / "sv"),
        ]
    )
    return td


def test_pgr_shmmr_count(test_data_dir, tmp_path, capsys):
    from pgrtk.cli import pgr_shmmr_count

    ref = os.path.join(test_data_dir, "test_agc_ref.fa")
    qry = os.path.join(test_data_dir, "test_agc_seqs.fa")
    out = str(tmp_path / "counts.tsv")
    assert pgr_shmmr_count.main([ref, ref, qry, "-o", out]) == 0
    lines = open(out).read().splitlines()
    assert lines
    for ln in lines:
        parts = ln.split("\t")
        assert len(parts) >= 4
        int(parts[1]), int(parts[2])


def test_pgr_compare_cov(test_data_dir, tmp_path):
    from pgrtk.cli import pgr_compare_cov

    l0 = tmp_path / "set0.txt"
    l0.write_text(os.path.join(test_data_dir, "test_agc_ref.fa") + "\n")
    l1 = tmp_path / "set1.txt"
    l1.write_text(os.path.join(test_data_dir, "test_agc_seqs.fa") + "\n")
    prefix = str(tmp_path / "cov")
    assert pgr_compare_cov.main([str(l0), str(l1), prefix]) == 0
    got = open(prefix + ".0.bedgraph").read()
    expect = open(
        os.path.join(
            os.path.dirname(__file__), "goldens", "compare_cov.0.bedgraph"
        )
    ).read()
    assert got == expect


def test_pgr_compare_cov2(test_data_dir, tmp_path):
    from pgrtk.cli import pgr_compare_cov2

    db = pgrtk.SeqIndexDB()
    db.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))
    srcs = sorted({src for _c, src, _l in db.seq_info.values() if src})
    spec = tmp_path / "jobs.txt"
    prefix = str(tmp_path / "cc2")
    spec.write_text(f"{prefix}\t{srcs[0]}\t{srcs[0]}\n")
    assert pgr_compare_cov2.main(
        [str(spec), "-f", os.path.join(test_data_dir, "test_seqs_frag")]
    ) == 0
    assert open(prefix + ".0.bedgraph").read().splitlines()


def test_pgr_annotate_bed_and_vcf(tmp_path, sv_outputs):
    from pgrtk.cli import pgr_annotate

    import gzip

    ann = tmp_path / "ann.gtf.gz"
    gtf = (
        'ctg1\tsrc\ttranscript\t1\t1000000\t.\t+\t.\t'
        'gene_id "G1"; gene_name "geneA"\n'
        'ctg2\tsrc\ttranscript\t1\t1000000\t.\t+\t.\t'
        'gene_id "G2"; gene_name "geneB"\n'
    )
    with gzip.open(ann, "wt") as f:
        f.write(gtf)
    bed = tmp_path / "in.bed"
    bed.write_text(
        "ctg1\t100\t200\tA\nctg2\t5\t50\tB\nctgX\t1\t2\tC\n"
    )
    out = tmp_path / "out.bed"
    assert pgr_annotate.main_bed([str(bed), str(ann), str(out)]) == 0
    lines = open(out).read().splitlines()
    assert any("geneA" in l for l in lines)

    vcf_in = sv_outputs / "sv.vcf"
    out_vcf = tmp_path / "out.vcf"
    assert pgr_annotate.main_vcf([str(vcf_in), str(ann), str(out_vcf)]) == 0
    assert open(out_vcf).read()


def test_pgr_generate_diploid_vcf(tmp_path, sv_outputs):
    from pgrtk.cli import pgr_generate_diploid_vcf as dv

    out = tmp_path / "diploid.vcf"
    assert dv.main(
        [
            str(sv_outputs / "sv.alnmap"),
            str(sv_outputs / "sv.alnmap"),
            str(sv_outputs / "sv.target_len.json"),
            str(out),
            "--sample-name", "S1",
        ]
    ) == 0
    txt = open(out).read()
    assert txt.startswith("##fileformat=VCF")
    body = [l for l in txt.splitlines() if not l.startswith("#")]
    # both haps identical => every genotyped call is homozygous
    assert body and all(l.split("\t")[-1].startswith(("1|1", "1/1"))
                        for l in body)


def test_pgr_generate_chr_aln_plot(tmp_path, sv_outputs):
    from pgrtk.cli import pgr_generate_chr_aln_plot as cap

    prefix = str(tmp_path / "plot")
    assert cap.main(
        [str(sv_outputs / "sv.ctgmap.json"), prefix, "--svg"]
    ) == 0
    svgs = [p for p in os.listdir(tmp_path) if p.endswith(".svg")]
    assert svgs and "<svg" in open(tmp_path / svgs[0]).read()


@pytest.fixture(scope="module")
def pbundle_bed(test_data_dir, tmp_path_factory):
    from pgrtk.cli import pgr_pbundle_decomp as pbd

    td = tmp_path_factory.mktemp("pb")
    pbd.main([os.path.join(test_data_dir, "test_seqs.fa"), str(td / "pb")])
    return td / "pb.bed"


GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def test_pgr_pbundle_aln(tmp_path, pbundle_bed):
    from pgrtk.cli import pgr_pbundle_aln
    from pgrtk.cli.pgr_pbundle_bed2dist import read_bed

    ctgs = [c for c, _ in read_bed(str(pbundle_bed))][:3]
    spec = tmp_path / "spec.txt"
    spec.write_text("\n".join(ctgs) + "\n")
    prefix = str(tmp_path / "aln")
    assert pgr_pbundle_aln.main(
        [str(pbundle_bed), str(spec), prefix]
    ) == 0
    got = open(prefix + ".bln.json").read()
    expect = open(os.path.join(GOLDEN_DIR, "pbundle_aln.bln.json")).read()
    assert got == expect


def test_pgr_pbundle_bed2svg(tmp_path, pbundle_bed):
    from pgrtk.cli import pgr_pbundle_bed2svg as b2s

    prefix = str(tmp_path / "view")
    assert b2s.main([str(pbundle_bed), prefix]) == 0
    got = open(prefix + ".svg").read()
    expect = open(os.path.join(GOLDEN_DIR, "pbundle_view.svg")).read()
    assert got == expect


def test_pgr_pbundle_bed2dist_snapshot(tmp_path, pbundle_bed):
    from pgrtk.cli import pgr_pbundle_bed2dist as b2d

    prefix = str(tmp_path / "dist")
    assert b2d.main([str(pbundle_bed), prefix]) == 0
    for ext in (".dist", ".nwk", ".ddg"):
        got = open(prefix + ext).read()
        expect = open(
            os.path.join(GOLDEN_DIR, "pbundle_dist" + ext)
        ).read()
        assert got == expect, ext


def test_pgr_filter_cli(test_data_dir, capsys):
    from pgrtk.cli import pgr_filter

    ref = os.path.join(test_data_dir, "test_agc_ref.fa")
    qry = os.path.join(test_data_dir, "test_agc_seqs.fa")
    assert pgr_filter.main([ref, "-q", qry]) == 0
    out = capsys.readouterr().out
    n = sum(1 for l in out.splitlines() if l.startswith(">"))
    assert n >= 60  # same-locus reads pass the minimizer screen


def test_sv_pipeline_localizes_planted_events(tmp_path):
    """End-to-end SV check with known ground truth: a 0.2%-divergent
    assembly with a planted 1.5kb deletion and a 1kb insertion must
    yield SVC candidate records overlapping both events."""
    import numpy as np

    from pgrtk.cli import pgr_get_sv_candidate_regions as sv

    rng = np.random.default_rng(12)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = 400_000
    ref = rng.integers(0, 4, size=L, dtype=np.uint8)
    (tmp_path / "ref.fa").write_bytes(
        b">ref\n" + bases[ref].tobytes() + b"\n"
    )
    s = ref.copy()
    m = rng.random(L) < 0.002
    s[m] = (s[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
    DEL_AT, DEL_LEN, INS_AT, INS_LEN = 100_000, 1500, 300_000, 1000
    s = np.concatenate([s[:DEL_AT], s[DEL_AT + DEL_LEN :]])
    ins = rng.integers(0, 4, size=INS_LEN, dtype=np.uint8)
    s = np.concatenate([s[: INS_AT - DEL_LEN], ins, s[INS_AT - DEL_LEN :]])
    (tmp_path / "asm.fa").write_bytes(
        b">asm\n" + bases[s].tobytes() + b"\n"
    )

    sv.main([
        str(tmp_path / "ref.fa"), str(tmp_path / "asm.fa"),
        str(tmp_path / "out"), "--number-of-thread", "1",
    ])
    svc = []
    for line in open(tmp_path / "out.svcnd.bed"):
        cols = line.split("\t")
        if len(cols) >= 4 and cols[3].startswith("SVC:"):
            svc.append((int(cols[1]), int(cols[2])))
    assert svc, "no SV candidate regions emitted"

    def covered(pos):
        return any(b <= pos <= e for b, e in svc)

    assert covered(DEL_AT), f"deletion at {DEL_AT} not in {svc}"
    assert covered(INS_AT), f"insertion at {INS_AT} not in {svc}"
    # SNVs from the 0.2% divergence must be called as variants
    n_var = sum(
        1 for line in open(tmp_path / "out.vcf") if not line.startswith("#")
    )
    assert n_var > 200


def test_pgr_probe_match_cli(tmp_path, capsys):
    from pgrtk.cli import pgr_probe_match

    reads = tmp_path / "reads.fa"
    reads.write_text(
        ">r1\nAAAACCCCGGGGTTTTAAGGCCTTAACC\n"   # vprobe + t1probe
        ">r2\nGGTTAAGGCCTTCCCCGGGGA\n"           # vprobe (palindromic) + t2
        ">r3\nTTTTTTTTTTTTTTTTTTTT\n"            # no match
        ">r4\nACCCCGGGTTGCAGCAGCAGAA\n"          # vprobe-ish? no exact\n
    )
    probes = tmp_path / "probes.tsv"
    probes.write_text("V1\tCCCCGGGG\tT1\tAAGGCCTT\tT2\tGGTTAAGG\n")
    assert pgr_probe_match.main(
        [str(probes), "-q", str(reads)]
    ) == 0
    out = capsys.readouterr().out.strip()
    # r1 matches V (fwd) + T1; r2 matches V + T1(rc: AAGGCCTT present) + T2
    fields = out.split()
    assert fields[0] == "V1" and fields[2] == "T1" and fields[4] == "T2"
    assert int(fields[1]) == 2
    assert int(fields[3]) == 2
    assert int(fields[5]) >= 1


def test_pgr_multifilter_cli(tmp_path, test_data_dir):
    from pgrtk.cli import pgr_multifilter

    ref = os.path.join(test_data_dir, "test_agc_ref.fa")
    qry = os.path.join(test_data_dir, "test_agc_seqs.fa")
    unrelated = tmp_path / "unrelated.fa"
    unrelated.write_text(">u1\n" + "ACGT" * 64 + "\n")
    lst = tmp_path / "refs.tsv"
    lst.write_text(f"{ref}\tlocus\n{unrelated}\tnone\n")
    assert pgr_multifilter.main(
        [str(lst), str(tmp_path / "out"), "-q", qry]
    ) == 0
    locus = (tmp_path / "out_locus.fa").read_text()
    none = (tmp_path / "out_none.fa").read_text()
    n_locus = sum(1 for l in locus.splitlines() if l.startswith(">"))
    n_none = sum(1 for l in none.splitlines() if l.startswith(">"))
    assert n_locus >= 60   # same-locus reads pass their filter
    assert n_none == 0     # nothing passes the unrelated filter


def test_pgr_fasta_smp_count_cli(tmp_path, test_data_dir):
    from pgrtk.cli import pgr_fasta_smp_count

    out = tmp_path / "counts.txt"
    fa = os.path.join(test_data_dir, "test_seqs.fa")
    assert pgr_fasta_smp_count.main(
        ["-i", fa, "-o", str(out), "-m", "2", "-w", "31", "-k", "31",
         "-r", "1"]
    ) == 0
    lines = out.read_text().splitlines()
    assert len(lines) > 50
    k0, k1, c = lines[0].split()
    assert len(k0) == 16 and len(k1) == 16 and int(c) >= 2
    # sorted canonical order
    keys = [tuple(l.split()[:2]) for l in lines]
    assert keys == sorted(keys)


def test_pgr_shmmr_pair_count_cli(tmp_path, test_data_dir):
    from pgrtk.cli import pgr_shmmr_pair_count

    prefix = os.path.join(test_data_dir, "test_seqs_frag")
    out = tmp_path / "spc.txt"
    assert pgr_shmmr_pair_count.main(
        [prefix, "-o", str(out), "-m", "2"]
    ) == 0
    lines = out.read_text().splitlines()
    # independent re-derivation: counts must equal a direct pass over
    # the .mdb postings with the .midx sid->source mapping
    from pgrtk.core import mdb as mdb_mod

    _spec, fm = mdb_mod.read_mdb(prefix + ".mdb")
    sid_src = {}
    srcs = {}
    with open(prefix + ".midx") as f:
        for line in f:
            sid_s, _l, _c, source = line.rstrip("\n").split("\t")
            srcs.setdefault(source, len(srcs))
            sid_src[int(sid_s)] = srcs[source]
    expected = []
    for key in sorted(fm):
        cnt = {}
        for _fid, sid, _b, _e, _o in fm[key]:
            cnt[sid_src[sid]] = cnt.get(sid_src[sid], 0) + 1
        n = sum(1 for v in cnt.values() if v <= 2)
        expected.append(f"{key[0]} {key[1]} {n}")
    assert lines == expected


def test_pgr_compare_cov_from_prebuilt_index(test_data_dir, tmp_path):
    """The -f/--frg-idx-prefix mode (reference:
    pgr-compare-cov.rs:305-509): ONE pre-built db whose sources
    partition into the two sample sets via the filepath lists; per-pair
    counts come from the shared fragment map, set0 rows report
    r = c1/c0 and set1 rows r = c0/c1."""
    from pgrtk.cli import pgr_compare_cov, pgr_make_frgdb

    fa0 = os.path.join(test_data_dir, "test_agc_ref.fa")
    fa1 = os.path.join(test_data_dir, "test_agc_seqs.fa")
    flist = tmp_path / "files.txt"
    flist.write_text(fa0 + "\n" + fa1 + "\n")
    dbp = str(tmp_path / "covdb")
    assert pgr_make_frgdb.main([str(flist), dbp]) == 0

    l0 = tmp_path / "set0.txt"
    l0.write_text(fa0 + "\n")
    l1 = tmp_path / "set1.txt"
    l1.write_text(fa1 + "\n")
    prefix = str(tmp_path / "icov")
    assert pgr_compare_cov.main(
        [str(l0), str(l1), prefix, "-f", dbp]
    ) == 0
    rows0 = [l.split("\t") for l in open(prefix + ".0.bedgraph")]
    rows1 = [l.split("\t") for l in open(prefix + ".1.bedgraph")]
    assert rows0 and rows1
    # set0 rows: (ctg, p0, p1, c1/c0, c0, c1) with c0 > 0
    for ctg, p0, p1, r, c0, c1 in rows0[:200]:
        assert int(c0) > 0
        assert abs(float(r) - int(c1) / int(c0)) < 1e-4
    for ctg, p0, p1, r, c1, c0 in rows1[:200]:
        assert int(c1) > 0
        assert abs(float(r) - int(c0) / int(c1)) < 1e-4


def test_pgr_generate_chr_aln_plot_cytoband(tmp_path, sv_outputs):
    """--cytoband-json stripes the reference track (gpos* black, acen
    yellow, others grey) with band-name tooltips."""
    import json

    from pgrtk.cli import pgr_generate_chr_aln_plot as cap

    with open(sv_outputs / "sv.ctgmap.json") as f:
        t_name = json.load(f)["target_length"][0][1]
    cyto = tmp_path / "cyto.json"
    cyto.write_text(json.dumps({
        "cytobands": {
            t_name: [
                [0, 50_000, "p11", "gneg"],
                [50_000, 120_000, "p12", "gpos50"],
                [120_000, 150_000, "cen", "acen"],
            ]
        }
    }))
    prefix = str(tmp_path / "cplot")
    assert cap.main([
        str(sv_outputs / "sv.ctgmap.json"), prefix, "--svg",
        "--cytoband-json", str(cyto),
    ]) == 0
    svg = open(prefix + ".svg").read()
    assert 'stroke="#AAA"' in svg       # gneg band
    assert 'stroke="#FF0"' in svg       # acen band
    assert "<title>p12</title>" in svg  # band tooltip


def test_pgr_mdb_prefetching_flag(test_data_dir, tmp_path):
    """-p/--prefetching must be accepted and produce a byte-identical
    index (it only changes the reader pipeline's read-ahead)."""
    from pgrtk.cli import pgr_mdb

    flist = tmp_path / "archives.txt"
    flist.write_text(os.path.join(test_data_dir, "test.agc") + "\n")
    a, b = str(tmp_path / "idxa"), str(tmp_path / "idxb")
    assert pgr_mdb.main([str(flist), a, "-s"]) == 0
    assert pgr_mdb.main([str(flist), b, "-s", "--prefetching"]) == 0
    assert open(a + ".mdb", "rb").read() == open(b + ".mdb", "rb").read()
    assert open(a + ".midx").read() == open(b + ".midx").read()
