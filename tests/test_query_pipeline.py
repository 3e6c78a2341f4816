"""End-to-end query pipeline tests: backend consistency, frg round-trip,
pgr-query CLI outputs."""
import os
import subprocess
import sys

import pytest

import pgrtk
from pgrtk.core.fasta import read_fastx_all, reverse_complement


@pytest.fixture(scope="module")
def dbs(test_data_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dbs")
    frg = pgrtk.SeqIndexDB()
    frg.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))
    fx = pgrtk.SeqIndexDB()
    fx.load_from_fastx(os.path.join(test_data_dir, "test_seqs.fa"))
    fx.write_frag_and_index_files(str(tmp / "ours"))
    ours = pgrtk.SeqIndexDB()
    ours.load_from_frg_index(str(tmp / "ours"))
    return frg, fx, ours


def test_backend_query_consistency(dbs, test_data_dir):
    frg, fx, ours = dbs
    queries = read_fastx_all(os.path.join(test_data_dir, "test_seqs2.fa.gz"))
    for rec in queries[:6]:
        r_frg = frg.query_fragment_to_hps(rec.seq, 0.025, 128, 128, 128, 8)
        r_fx = fx.query_fragment_to_hps(rec.seq, 0.025, 128, 128, 128, 8)
        r_ours = ours.query_fragment_to_hps(rec.seq, 0.025, 128, 128, 128, 8)
        assert r_frg == r_fx == r_ours
        assert r_frg, "query should hit"


def test_frg_roundtrip_reconstruction(dbs, test_data_dir):
    _, _, ours = dbs
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))
    for sid in (0, 5, 33, len(recs) - 1):
        assert ours.get_seq_by_id(sid) == recs[sid].seq


def test_match_positions(dbs, test_data_dir):
    frg, fx, _ = dbs
    queries = read_fastx_all(os.path.join(test_data_dir, "test_seqs2.fa.gz"))
    a = frg.get_match_positions_with_fragment(queries[0].seq)
    b = fx.get_match_positions_with_fragment(queries[0].seq)
    assert a == b and len(a) > 0


def test_pgr_query_cli(test_data_dir, tmp_path):
    out_prefix = str(tmp_path / "q")
    cmd = [
        sys.executable,
        "-m",
        "pgrtk.cli.pgr_query",
        os.path.join(test_data_dir, "test_seqs_frag"),
        os.path.join(test_data_dir, "test_seqs2.fa.gz"),
        out_prefix,
        "--frg-file",
    ]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    res = subprocess.run(cmd, capture_output=True, env=env)
    assert res.returncode == 0, res.stderr.decode()
    hit0 = out_prefix + ".000.hit"
    assert os.path.exists(hit0)
    lines = open(hit0).read().splitlines()
    assert lines[0].startswith("#idx")
    assert len(lines) > 1
    row = lines[1].split("\t")
    assert len(row) == 12
    # fasta exists and hit regions match the db subsequence
    fa0 = out_prefix + ".000.fa"
    fa = read_fastx_all(fa0)
    assert fa
    db = pgrtk.SeqIndexDB()
    db.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))
    name_to_info = {}
    for line in lines[1:]:
        f = line.split("\t")
        name_to_info[f[11]] = (f[7], int(f[8]), int(f[9]), int(f[10]), f[6])
    rec0 = fa[0]
    ctg, b, e, ori, src = name_to_info[rec0.id.decode()]
    expect = db.get_sub_seq(src, ctg, b, e)
    if ori == 1:
        expect = reverse_complement(expect)
    assert rec0.seq == expect


def test_pgr_make_frgdb_cli(test_data_dir, tmp_path):
    lst = tmp_path / "files.txt"
    lst.write_text(os.path.join(test_data_dir, "test_seqs.fa") + "\n")
    out_prefix = str(tmp_path / "mk")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    res = subprocess.run(
        [
            sys.executable,
            "-m",
            "pgrtk.cli.pgr_make_frgdb",
            str(lst),
            out_prefix,
        ],
        capture_output=True,
        env=env,
    )
    assert res.returncode == 0, res.stderr.decode()
    from pgrtk.core import mdb

    _, golden = mdb.read_mdb(
        os.path.join(test_data_dir, "test_seqs_frag.mdb")
    )
    _, built = mdb.read_mdb(out_prefix + ".mdb")
    assert golden == built


def test_device_batch_query_matches_host(test_data_dir):
    """Device-sketched batch query == host per-query path (mode-1 FRG db)."""
    import pgrtk
    from pgrtk.core.fasta import read_fastx_all
    from pgrtk.parallel import device_query

    db = pgrtk.SeqIndexDB()
    db.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs2.fa.gz"))[:3]
    seqs = [r.seq[1000:9000] for r in recs]

    got = device_query.batch_query_to_hps(db, seqs)
    for seq, dev in zip(seqs, got):
        host = db.query_fragment_to_hps(seq, 0.025)
        assert dev == host


def test_vectorized_query_pairs_match_scalar_path_with_ties(monkeypatch):
    """raw_query_fragment's vectorized branch (lookup.many) must produce
    the same FragmentHit stream as the scalar branch, including the
    strict-< tie rule (equal adjacent hashes -> orientation 1)."""
    import numpy as np

    from pgrtk.core import query as query_mod
    from pgrtk.core import sketch as sketch_mod
    from pgrtk.core.spec import ShmmrSpec

    rng = np.random.RandomState(3)
    n = 64
    x = (rng.randint(0, 1 << 40, n).astype(np.uint64) << np.uint64(8)) | np.uint64(56)
    x[10] = x[11]  # adjacent equal hashes: tie
    x[30] = x[31] = x[32]  # run of ties
    pos = np.sort(rng.choice(100000, n, replace=False)).astype(np.uint64)
    y = pos << np.uint64(1)

    monkeypatch.setattr(
        sketch_mod, "sequence_to_shmmrs_arrays", lambda *a, **k: (x, y)
    )
    monkeypatch.setattr(
        sketch_mod,
        "sequence_to_shmmrs",
        lambda *a, **k: list(zip(x.tolist(), y.tolist())),
    )

    calls = {}

    def scalar_lookup(s0, s1):
        calls.setdefault("scalar", 0)
        calls["scalar"] += 1
        return [(1, 2, 3, 4, 0)] if (s0 + s1) % 3 == 0 else []

    def many(s0_arr, s1_arr):
        return [scalar_lookup(int(a), int(b)) for a, b in zip(s0_arr, s1_arr)]

    spec = ShmmrSpec(sketch=True)
    scalar_out = query_mod.raw_query_fragment(scalar_lookup, b"ACGT", spec)

    vec_lookup = lambda s0, s1: scalar_lookup(s0, s1)  # noqa: E731
    vec_lookup.many = many
    vec_out = query_mod.raw_query_fragment(vec_lookup, b"ACGT", spec)

    assert vec_out == scalar_out
    # the tie pairs must carry orientation 1 with unswapped keys
    ties = [h for h in scalar_out if h[0][0] == h[0][1]]
    assert len(ties) == 3
    assert all(h[1][2] == 1 for h in ties)


def test_native_frg_reconstruction_matches_python(test_data_dir):
    """native/src/frg.cc (decompress + bincode parse + delta apply + rc
    in C++) must reconstruct exactly what the Python fallback does —
    full sequences, per-fragment offsets, and random sub-ranges — on the
    REFERENCE-written .frg store."""
    import numpy as np

    from pgrtk.core.frag_io import FragFileStorage

    st = FragFileStorage(
        os.path.join(test_data_dir, "test_seqs_frag")
    )
    if st._native_api() is None:  # pragma: no cover
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(0)
    api = st._native
    for sid in range(0, len(st.seqs), 5):
        slen = st.seqs[sid][4]
        nat_full = st.get_seq_by_id(sid)
        nat_offs = st._frag_offsets(sid).copy()
        st._native = False
        st._seq_off_cache.clear()
        py_full = st.get_seq_by_id(sid)
        py_offs = st._frag_offsets(sid)
        assert nat_full == py_full, sid
        assert np.array_equal(nat_offs, py_offs), sid
        for _ in range(4):
            b = int(rng.integers(0, slen - 1))
            e = int(rng.integers(b + 1, slen + 1))
            py_sub = st.get_sub_seq_by_id(sid, b, e)
            st._native = api
            st._seq_off_cache.clear()
            nat_sub = st.get_sub_seq_by_id(sid, b, e)
            assert nat_sub == py_sub, (sid, b, e)
            st._native = False
            st._seq_off_cache.clear()
        st._native = api
        st._seq_off_cache.clear()


def test_frg_reader_survives_corrupt_input(test_data_dir, tmp_path):
    """Bit-flipped / truncated .frg files must raise clean Python
    exceptions (or reconstruct unaffected sequences), never crash the
    process — the reference's AGC wrapper documents that corrupt
    archives segfault (agc_io.rs:71-75); the native frg path fails to
    the Python codec, which raises."""
    import shutil

    import numpy as np

    from pgrtk.core.frag_io import FragFileStorage

    src_prefix = os.path.join(test_data_dir, "test_seqs_frag")
    rng = np.random.default_rng(13)
    frg = open(src_prefix + ".frg", "rb").read()
    n_ok = n_raised = 0
    for trial in range(20):
        pref = str(tmp_path / f"c{trial}")
        for ext in (".sdx", ".mdb", ".midx"):
            shutil.copy(src_prefix + ext, pref + ext)
        buf = bytearray(frg)
        if trial % 4 == 0:  # truncate
            buf = buf[: len(buf) // (2 + trial % 3)]
        else:  # flip a handful of payload bytes
            for p in rng.integers(8, len(buf), size=8):
                buf[p] ^= 0xFF
        with open(pref + ".frg", "wb") as f:
            f.write(bytes(buf))
        try:
            st = FragFileStorage(pref)
            for sid in (0, 7, 33):
                st.get_seq_by_id(sid)
                st.get_sub_seq_by_id(sid, 10, 500)
            n_ok += 1
        except Exception:
            n_raised += 1
    assert n_ok + n_raised == 20  # every trial ended in python control
    assert n_raised > 0  # the corruptions were real


def test_frg_native_crafted_payloads_fail_cleanly():
    """A VALID deflate stream can still carry a malicious bincode payload
    (random bit flips fail inflate first and never reach the parser).
    Huge varint counts must be rejected before any reserve/loop — the
    unhardened parser died in std::length_error -> std::terminate
    (ADVICE r4 high).  Each crafted group must return -1, not crash."""
    import zlib

    import numpy as np

    from pgrtk.native import api as napi

    if not napi.available():
        pytest.skip("native library unavailable")

    def varint(v):
        if v < 0xFB:
            return bytes([v])
        if v <= 0xFFFF:
            return b"\xfb" + v.to_bytes(2, "little")
        if v <= 0xFFFFFFFF:
            return b"\xfc" + v.to_bytes(4, "little")
        return b"\xfd" + v.to_bytes(8, "little")

    huge = 2**63
    payloads = [
        # fragment count = 2^63 -> reserve() bomb
        varint(huge),
        # count ok, Internal fragment claiming 2^63 payload bytes
        # (pos += n signed-overflow path)
        varint(1) + varint(2) + varint(huge),
        # count ok, ALN fragment with 2^63 segments (unbounded seg loop)
        varint(1) + varint(0) + varint(0) + b"\x00" + varint(100)
        + varint(huge),
        # ALN with plausible seg count but truncated segment stream
        varint(1) + varint(0) + varint(0) + b"\x00" + varint(100)
        + varint(3) + varint(1),
        # truncated varint at end of buffer (0xFD with no payload)
        varint(2) + varint(2) + varint(4) + b"ACGT" + b"\xfd",
        # ALN whose base id points past the group's fragments
        varint(1) + varint(0) + varint(9999) + b"\x00" + varint(4)
        + varint(1) + varint(0),
    ]
    for i, payload in enumerate(payloads):
        co = zlib.compressobj(9, zlib.DEFLATED, -15)
        blob = co.compress(payload) + co.flush()
        frg = np.frombuffer(blob, dtype=np.uint8)
        grp_off = np.zeros(1, dtype=np.int64)
        grp_size = np.array([len(blob)], dtype=np.int64)
        out = np.zeros(4, dtype=np.int64)
        lib = napi._load()
        rc = lib.pgr_frg_base_lens(
            frg, len(frg), grp_off, grp_size, 1, 256, 56, 0, 1, out)
        if i != 5:  # payload 5's header is well-formed (bad base ID is
            # only reachable at materialization time)
            assert rc == -1, f"payload {i} accepted"
        buf = np.zeros(4096, dtype=np.uint8)
        got = lib.pgr_frg_sub_bases(
            frg, len(frg), grp_off, grp_size, 1, 256, 56, 0, 1, buf,
            len(buf))
        assert got == -1, f"payload {i} materialized"
