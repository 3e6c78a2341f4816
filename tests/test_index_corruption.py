"""Corrupt-input hardening for the index formats (VERDICT r4 item 6).

`.agc`/`.frg` already have clean-exception tests (tests/test_agc.py,
tests/test_query_pipeline.py); this file extends the discipline to
`.mdb`/`.midx`/`.sdx`/`.pdb` — truncations, bit flips, and CRAFTED
headers (huge counts that would drive unbounded allocations) must end
in Python control with a clean exception (or parse unaffected content),
never a native crash, a wild allocation, or a hang.  The native
offsets scan (native/src/mdb.cc) is exercised directly as well as
through the reader dispatch.
"""
import os
import shutil

import numpy as np
import pytest

from pgrtk.core import mdb, pdb_io
from pgrtk.core.frag_io import FragFileStorage


@pytest.fixture(scope="module")
def frag_prefix(test_data_dir):
    return os.path.join(test_data_dir, "test_seqs_frag")


def _mdb_readers(path):
    yield lambda: mdb.read_mdb(path)
    yield lambda: mdb.read_mdb_columnar(path)
    yield lambda: mdb.read_mdb_lazy(path)


def test_mdb_truncation_and_bitflips(frag_prefix, tmp_path):
    src = open(frag_prefix + ".mdb", "rb").read()
    rng = np.random.default_rng(7)
    n_raised = 0
    for trial in range(18):
        buf = bytearray(src)
        if trial % 3 == 0:
            buf = buf[: 31 + (trial * 97) % max(1, len(buf) - 31)]
        else:
            for p in rng.integers(0, len(buf), size=6):
                buf[p] ^= 0xFF
        p = tmp_path / f"m{trial}.mdb"
        p.write_bytes(bytes(buf))
        for rd in _mdb_readers(str(p)):
            try:
                rd()
            except Exception:
                n_raised += 1
    assert n_raised > 0  # the corruptions were real


def test_mdb_crafted_huge_key_count(frag_prefix, tmp_path):
    """nkeys = 2^60 in the header: the unguarded native scan multiplied
    2*nkeys*8 (size_t wrap -> under-allocation -> heap overflow); both
    the native and Python scans must reject it before allocating."""
    src = bytearray(open(frag_prefix + ".mdb", "rb").read())
    src[23:31] = (1 << 60).to_bytes(8, "little")
    p = tmp_path / "huge.mdb"
    p.write_bytes(bytes(src))

    from pgrtk.native import api as napi

    if napi.available():
        with pytest.raises(Exception):
            napi.mdb_scan(str(p))
    for rd in _mdb_readers(str(p)):
        with pytest.raises(Exception):
            rd()


def test_mdb_crafted_huge_posting_count(frag_prefix, tmp_path):
    """First key's posting count = 2^62: 17*n wraps uint64 in the
    unguarded native scan; both paths must fail cleanly."""
    src = bytearray(open(frag_prefix + ".mdb", "rb").read())
    # first record: k0 u64, k1 u64, n u64 at offset 31
    src[31 + 16 : 31 + 24] = (1 << 62).to_bytes(8, "little")
    p = tmp_path / "hugen.mdb"
    p.write_bytes(bytes(src))

    from pgrtk.native import api as napi

    if napi.available():
        with pytest.raises(Exception):
            napi.mdb_scan(str(p))
    for rd in _mdb_readers(str(p)):
        with pytest.raises(Exception):
            rd()


def test_midx_garbage_lines(frag_prefix, tmp_path):
    src = open(frag_prefix + ".midx").read()
    for bad in (
        "not\ta\tvalid",                      # wrong field count
        "x\ty\tz\tw",                          # non-integer id/len
        src[: len(src) // 2] + "trailing junk no tabs",
    ):
        p = tmp_path / "bad.midx"
        p.write_text(bad + "\n")
        with pytest.raises(Exception):
            mdb.read_midx(str(p))


def _copy_prefix(frag_prefix, tmp_path, name):
    pref = str(tmp_path / name)
    for ext in (".frg", ".sdx", ".mdb", ".midx"):
        shutil.copy(frag_prefix + ext, pref + ext)
    return pref


def test_sdx_truncation_and_bitflips(frag_prefix, tmp_path):
    rng = np.random.default_rng(11)
    src = open(frag_prefix + ".sdx", "rb").read()
    n_ok = n_raised = 0
    for trial in range(16):
        pref = _copy_prefix(frag_prefix, tmp_path, f"s{trial}")
        buf = bytearray(src)
        if trial % 3 == 0:
            buf = buf[: 7 + (trial * 131) % max(1, len(buf) - 7)]
        else:
            for p in rng.integers(7, len(buf), size=5):
                buf[p] ^= 0xFF
        with open(pref + ".sdx", "wb") as f:
            f.write(bytes(buf))
        try:
            st = FragFileStorage(pref)
            for sid in (0, 7):
                st.get_seq_by_id(sid)
            n_ok += 1
        except Exception:
            n_raised += 1
    assert n_ok + n_raised == 16  # every trial ended in python control
    assert n_raised > 0


def test_sdx_crafted_huge_counts(frag_prefix, tmp_path):
    """Huge varint counts in the .sdx addr/seq vectors must raise, not
    allocate: each entry consumes >= 1 byte so the parse loop hits the
    buffer end long before a count of 2^60 materializes anything."""
    pref = _copy_prefix(frag_prefix, tmp_path, "craft")
    # payload starts after the 7-byte magic: chunk_size varint, then the
    # addrs count varint — overwrite it with 0xFD + 2^60
    src = bytearray(open(frag_prefix + ".sdx", "rb").read())
    r = 7
    # skip chunk_size varint
    b = src[r]
    r += 1 + (0 if b < 0xFB else {0xFB: 2, 0xFC: 4, 0xFD: 8}[b])
    crafted = src[:r] + b"\xfd" + (1 << 60).to_bytes(8, "little") + src[r:]
    with open(pref + ".sdx", "wb") as f:
        f.write(bytes(crafted))
    with pytest.raises(Exception):
        FragFileStorage(pref)


def test_pdb_truncation_and_bitflips(tmp_path):
    golden = os.path.join(os.path.dirname(__file__), "data", "golden.pdb")
    src = open(golden, "rb").read()
    rng = np.random.default_rng(5)
    n_raised = 0
    for trial in range(14):
        buf = bytearray(src)
        if trial % 3 == 0:
            buf = buf[: 7 + trial * 5]
        else:
            for p in rng.integers(7, len(buf), size=3):
                buf[p] ^= 0xFF
        p = tmp_path / "c.pdb"
        p.write_bytes(bytes(buf))
        try:
            pdb_io.read_pdb(str(p))
        except Exception:
            n_raised += 1
    assert n_raised > 0


def test_pdb_crafted_huge_counts(tmp_path):
    """Bundle/path/map counts of 2^60 must raise (loop bounded by the
    buffer, each entry >= 1 byte), not hang or allocate."""
    head = b"PDB:0.5" + bytes([48, 56, 4, 12, 8, 2])
    for tail in (
        b"\xfd" + (1 << 60).to_bytes(8, "little"),              # bundles
        b"\x01\x00\x00" + b"\xfd" + (1 << 60).to_bytes(8, "little"),  # path
        b"\x00" + b"\xfd" + (1 << 60).to_bytes(8, "little"),    # vmap
    ):
        p = tmp_path / "h.pdb"
        p.write_bytes(head + tail)
        with pytest.raises(Exception):
            pdb_io.read_pdb(str(p))


def test_frg_native_group_offset_size_overflow():
    """Crafted .sdx group entries (offset=1, size=2^63-1) wrapped the
    old `off + sz > len` sum check and let inflate read past the frg
    buffer (round-5 review finding) — must fail cleanly."""
    from pgrtk.native import api as napi

    if not napi.available():
        pytest.skip("native library unavailable")
    lib = napi._load()
    frg = np.zeros(64, dtype=np.uint8)
    out = np.zeros(4, dtype=np.int64)
    for off, size in ((1, (1 << 63) - 1), (-5, 10), (60, 1 << 40)):
        grp_off = np.array([off], dtype=np.int64)
        grp_size = np.array([size], dtype=np.int64)
        rc = lib.pgr_frg_base_lens(
            frg, len(frg), grp_off, grp_size, 1, 256, 56, 0, 1, out)
        assert rc == -1, (off, size)


def test_agc_trailer_size_overflow(tmp_path):
    """footer_size = 2^64-1 wrapped `footer_size + 8 > fsize` and drove
    std::vector(footer_size) to terminate the process (reproduced in
    the round-5 review) — must raise cleanly now."""
    from pgrtk.core.agc import AgcFile

    p = tmp_path / "wrap.agc"
    p.write_bytes(b"\x00" * 72 + b"\xff" * 8)
    with pytest.raises(Exception):
        AgcFile(str(p))


def test_pga_segment_offset_overflow(tmp_path):
    """sg.offset near 2^64 wrapped the segment-bound sum check — the
    open must reject the index."""
    import struct

    from pgrtk.core import pga as pga_mod

    idx = struct.pack("<I", 1)                      # 1 sample
    idx += struct.pack("<H", 1) + b"s"              # name "s"
    idx += struct.pack("<I", 1)                     # 1 contig
    idx += struct.pack("<H", 1) + b"c"              # name "c"
    idx += struct.pack("<QQ", 100, 0)               # len, global_start
    idx += struct.pack("<Q", 1)                     # 1 segment
    idx += struct.pack("<QII", (1 << 64) - 8, 64, 100)  # crafted offset
    blob = b"PGA:0.1\x00" + struct.pack("<Q", 16 + 64) + b"\x00" * 64 + idx
    p = tmp_path / "wrap.pga"
    p.write_bytes(blob)
    with pytest.raises(Exception):
        pga_mod.PgaFile(str(p))
