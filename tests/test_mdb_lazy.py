"""Lazy (mmap, offsets-only) .mdb reader vs the full columnar parse."""
import os
import resource
import struct

import numpy as np
import pytest

from pgrtk.core import mdb
from pgrtk.core.spec import ShmmrSpec


def _write_synthetic_mdb(path, nkeys, sigs_per_key, seed=0):
    """Stream a synthetic .mdb to disk without holding it in memory."""
    rng = np.random.RandomState(seed)
    spec = ShmmrSpec()
    keys = np.sort(
        rng.randint(0, 1 << 56, size=nkeys, dtype=np.uint64)
    )
    with open(path, "wb") as f:
        f.write(b"mdb")
        f.write(struct.pack("<5I", spec.w, spec.k, spec.r, spec.min_span, 1))
        f.write(struct.pack("<Q", nkeys))
        for i in range(nkeys):
            n = sigs_per_key
            f.write(struct.pack("<3Q", int(keys[i]), int(keys[i]) ^ 0xABC, n))
            block = np.zeros(n, dtype=mdb.SIG_DTYPE)
            block["frg_id"] = np.arange(n) + i
            block["seq_id"] = i % 97
            block["bgn"] = np.arange(n) * 11
            block["end"] = np.arange(n) * 11 + 56
            block["orientation"] = (np.arange(n) + i) & 1
            f.write(block.tobytes())
    return keys


def test_lazy_matches_columnar(tmp_path):
    path = str(tmp_path / "t.mdb")
    _write_synthetic_mdb(path, nkeys=300, sigs_per_key=5)
    spec_c, keys_c, starts_c, counts_c, sigs_c = mdb.read_mdb_columnar(path)
    spec_l, keys_l, starts_l, counts_l, sigs_l = mdb.read_mdb_lazy(path)
    assert spec_c == spec_l
    assert np.array_equal(keys_c, keys_l)
    assert np.array_equal(starts_c, starts_l)
    assert np.array_equal(counts_c, counts_l)
    assert len(sigs_l) == len(sigs_c)
    for i in range(len(keys_c)):
        s, c = int(starts_c[i]), int(counts_c[i])
        assert np.array_equal(sigs_c[s : s + c], sigs_l[s : s + c]), i


def test_lazy_slice_guard(tmp_path):
    path = str(tmp_path / "t.mdb")
    _write_synthetic_mdb(path, nkeys=4, sigs_per_key=3)
    _, _, starts, counts, sigs = mdb.read_mdb_lazy(path)
    with pytest.raises(IndexError):
        sigs[int(starts[0]) : int(starts[0]) + int(counts[0]) + 1]


def test_auto_selects_by_size_and_env(tmp_path, monkeypatch):
    path = str(tmp_path / "t.mdb")
    _write_synthetic_mdb(path, nkeys=10, sigs_per_key=2)
    out = mdb.read_mdb_auto(path)
    assert isinstance(out[4], np.ndarray)  # small file -> columnar
    monkeypatch.setenv("PGRTK_MDB_LAZY", "1")
    out = mdb.read_mdb_auto(path)
    assert isinstance(out[4], mdb.LazySigs)


def _current_rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


def test_lazy_bounded_rss_on_large_file(tmp_path):
    """A query against an index much larger than the resident budget:
    key metadata loads, posting pages only page in on demand.  Measured
    as CURRENT resident set (statm), not peak — the offsets scan maps
    page-cache pages transiently (clean, file-backed, reclaimable) and
    unmaps them before returning."""
    path = str(tmp_path / "big.mdb")
    # ~70 MB: 2000 keys x 2048 sigs x 17 B
    _write_synthetic_mdb(path, nkeys=2000, sigs_per_key=2048)
    size = os.path.getsize(path)
    assert size > 60 << 20
    rss0 = _current_rss()
    _, keys, starts, counts, sigs = mdb.read_mdb_lazy(path)
    # touch 20 scattered blocks (the query access pattern)
    for i in range(0, 2000, 100):
        s, c = int(starts[i]), int(counts[i])
        block = sigs[s : s + c]
        assert len(block) == c
    grew = _current_rss() - rss0
    # key metadata (32 B/key) + 20 touched blocks stay far below the
    # file size (the columnar reader would materialize all ~70 MB)
    assert grew < size // 4, (grew, size)


def test_lazy_query_end_to_end_matches_columnar(
    test_data_dir, monkeypatch
):
    """Full FRG query through the lazy reader == the columnar reader on
    the reference-written test_seqs_frag db."""
    from pgrtk.api import SeqIndexDB
    from pgrtk.core.fasta import read_fastx_all

    prefix = os.path.join(test_data_dir, "test_seqs_frag")
    db_c = SeqIndexDB()
    db_c.load_from_frg_index(prefix)
    monkeypatch.setenv("PGRTK_MDB_LAZY", "1")
    db_l = SeqIndexDB()
    db_l.load_from_frg_index(prefix)
    assert isinstance(db_l.frg_db.index_sigs, mdb.LazySigs)
    queries = read_fastx_all(
        os.path.join(test_data_dir, "test_seqs2.fa.gz")
    )
    for rec in queries[:3]:
        a = db_c.query_fragment_to_hps(rec.seq, 0.025, 128, 128, 128, 8)
        b = db_l.query_fragment_to_hps(rec.seq, 0.025, 128, 128, 128, 8)
        assert a == b and a
