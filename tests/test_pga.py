"""PGA archive backend tests."""
import os
import subprocess
import sys

import pytest

import pgrtk
from pgrtk.core import pga
from pgrtk.core.fasta import read_fastx_all
from pgrtk.native import api as native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable"
)


@pytest.fixture(scope="module")
def archive(test_data_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pga")
    path = str(tmp / "test.pga")
    pga.create_pga(
        path,
        [
            os.path.join(test_data_dir, "test_agc_ref.fa"),
            os.path.join(test_data_dir, "test_agc_seqs.fa"),
        ],
        level=19,
    )
    return path


def test_archive_roundtrip(archive, test_data_dir):
    f = pga.PgaFile(archive)
    assert f.list_samples() == ["test_agc_ref.fa", "test_agc_seqs.fa"]
    recs = {
        r.id.decode(): r.seq
        for r in read_fastx_all(
            os.path.join(test_data_dir, "test_agc_seqs.fa")
        )
    }
    ctgs = f.list_ctgs("test_agc_seqs.fa")
    assert {c for c, _ in ctgs} == set(recs)
    for ctg, ln in ctgs:
        assert ln == len(recs[ctg])
        assert f.get_seq("test_agc_seqs.fa", ctg) == recs[ctg]
        assert (
            f.get_sub_seq("test_agc_seqs.fa", ctg, 17, 450)
            == recs[ctg][17:450]
        )
    assert f.get_ctg_len("test_agc_seqs.fa", ctgs[0][0]) == ctgs[0][1]


def test_agc_backend_query(archive, test_data_dir, tmp_path):
    prefix = str(tmp_path / "idx")
    # build .mdb/.midx from the archive, then query through the facade
    lst = tmp_path / "list.txt"
    lst.write_text(archive + "\n")
    from pgrtk.cli import pgr_mdb

    assert pgr_mdb.main([str(lst), prefix]) == 0
    os.link(archive, prefix + ".pga") if not os.path.exists(
        prefix + ".pga"
    ) else None
    db = pgrtk.SeqIndexDB()
    db.load_from_agc_index(prefix)
    assert len(db.seq_info) == 66
    q = read_fastx_all(os.path.join(test_data_dir, "test_agc_seqs.fa"))[0]
    r = db.query_fragment_to_hps(q.seq, 0.025, 128, 128, 128, 8)
    assert r and r[0][0] == 0
    # fetch paths through the facade
    name, src, ln = db.seq_info[0]
    assert db.get_sub_seq(src, name, 0, 50) == q.seq[:50]


def test_fetch_seqs_cli(archive, tmp_path):
    prefix = str(tmp_path / "idx")
    lst = tmp_path / "list.txt"
    lst.write_text(archive + "\n")
    from pgrtk.cli import pgr_mdb

    assert pgr_mdb.main([str(lst), prefix]) == 0
    if not os.path.exists(prefix + ".pga"):
        os.link(archive, prefix + ".pga")
    env = dict(
        os.environ,
        PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    r = subprocess.run(
        [
            sys.executable, "-m", "pgrtk.cli.pgr_fetch_seqs", prefix,
            "--list",
        ],
        capture_output=True, env=env,
    )
    assert r.returncode == 0, r.stderr.decode()
    lines = r.stdout.decode().splitlines()
    assert len(lines) == 66
    sid, src, ctg, length = lines[0].split("\t")
    region = tmp_path / "regions.txt"
    region.write_text(f"lbl\t{src}\t{ctg}\t0\t40\t0\n")
    r = subprocess.run(
        [
            sys.executable, "-m", "pgrtk.cli.pgr_fetch_seqs", prefix,
            "--region-file", str(region),
        ],
        capture_output=True, env=env,
    )
    assert r.returncode == 0, r.stderr.decode()
    out = r.stdout.decode().splitlines()
    assert out[0] == ">lbl" and len(out[1]) == 40


def test_pga_reader_survives_corrupt_input(tmp_path):
    """Bit-flipped / truncated .pga archives must raise clean Python
    exceptions (or read unaffected content), never crash — the same
    discipline as the .agc/.frg/.mdb corruption suites."""
    import numpy as np

    from pgrtk.core import pga as pga_mod

    src = tmp_path / "base.fa"
    rng = np.random.default_rng(3)
    with open(src, "w") as f:
        for i in range(4):
            seq = "".join("ACGT"[v] for v in rng.integers(0, 4, 5000))
            f.write(f">ctg{i}\n{seq}\n")
    arc = tmp_path / "base.pga"
    pga_mod.create_pga(str(arc), [str(src)])
    blob = arc.read_bytes()

    n_ok = n_raised = 0
    for trial in range(16):
        buf = bytearray(blob)
        if trial % 4 == 0:
            buf = buf[: 8 + (trial * 211) % max(1, len(buf) - 8)]
        else:
            for p in rng.integers(8, len(buf), size=6):
                buf[p] ^= 0xFF
        bad = tmp_path / f"c{trial}.pga"
        bad.write_bytes(bytes(buf))
        try:
            f = pga_mod.PgaFile(str(bad))
            for s in f.list_samples():
                for ctg, ln in f.list_ctgs(s):
                    f.get_sub_seq(s, ctg, 0, min(ln, 1000))
            f.close()
            n_ok += 1
        except Exception:
            n_raised += 1
    assert n_ok + n_raised == 16  # every trial ended in python control
    assert n_raised > 0
