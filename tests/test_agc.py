"""AGC v2 archive interop: the reference's own test.agc must decode
byte-exactly (it was generated from test_agc_ref.fa + test_agc_seqs.fa,
see /root/reference/pgr-db/test/test_data/gen_agc.sh)."""
import os
import random

import pytest

from pgrtk.core.agc import AgcFile, open_archive
from pgrtk.core.agc_ref import AgcReader
from pgrtk.core.fasta import read_fastx

TD = "/root/reference/pgr-db/test/test_data"
AGC = os.path.join(TD, "test.agc")


def _truth():
    seqs = {}
    for path, sample in [
        (os.path.join(TD, "test_agc_ref.fa"), "test_agc_ref"),
        (os.path.join(TD, "test_agc_seqs.fa"), "test_agc_seqs"),
    ]:
        for rec in read_fastx(path, keep_source=False):
            seqs[(sample, rec.id.decode())] = bytes(rec.seq)
    return seqs


@pytest.fixture(scope="module")
def truth():
    return _truth()


@pytest.fixture(scope="module")
def agc():
    return AgcFile(AGC)


def test_open_archive_sniffs_agc():
    a = open_archive(AGC)
    assert isinstance(a, AgcFile)


def test_samples_and_ctg_lens(agc, truth):
    assert agc.list_samples() == ["test_agc_ref", "test_agc_seqs"]
    assert len(agc.ctg_lens) == 66
    for (sample, ctg), ln in agc.ctg_lens.items():
        assert ln == len(truth[(sample, ctg)])
        assert agc.get_ctg_len(sample, ctg) == ln


def test_every_contig_byte_exact(agc, truth):
    for (sample, ctg), want in truth.items():
        assert agc.get_seq(sample, ctg) == want, (sample, ctg)


def test_sub_seq_random_ranges(agc, truth):
    rng = random.Random(7)
    keys = sorted(truth)
    for _ in range(50):
        sample, ctg = keys[rng.randrange(len(keys))]
        want = truth[(sample, ctg)]
        b = rng.randrange(len(want))
        e = rng.randrange(b, len(want) + 1)
        assert agc.get_sub_seq(sample, ctg, b, e) == want[b:e]
    # clamping / empty-range behavior
    sample, ctg = keys[0]
    want = truth[(sample, ctg)]
    assert agc.get_sub_seq(sample, ctg, 0, -1) == want
    assert agc.get_sub_seq(sample, ctg, 10, 10) == b""
    assert agc.get_sub_seq(sample, ctg, 0, 10**9) == want


def test_missing_contig_raises(agc):
    with pytest.raises(KeyError):
        agc.get_sub_seq("nope", "nothere", 0, -1)


def test_python_arbiter_matches_native(agc, truth):
    ref = AgcReader(AGC)
    assert ref.list_samples() == agc.list_samples()
    for (sample, ctg), want in truth.items():
        assert ref.get_seq(sample, ctg) == want, (sample, ctg)
    # spec params decoded from the archive
    assert (ref.k, ref.min_match, ref.pack_card, ref.seg_size) == (
        31, 20, 50, 60000,
    )


def test_load_from_agc_index_via_mdb(tmp_path, truth):
    """pgr-mdb over a real .agc, then load_from_agc_index + query."""
    from pgrtk.api import SeqIndexDB
    from pgrtk.cli import pgr_mdb

    prefix = str(tmp_path / "agcdb")
    listing = tmp_path / "archives.txt"
    listing.write_text(AGC + "\n")
    assert pgr_mdb.main([str(listing), prefix, "-s"]) == 0

    # the index prefix must sit next to the archive for the loader;
    # symlink the .agc next to the index files
    os.symlink(AGC, prefix + ".agc")
    db = SeqIndexDB()
    db.load_from_agc_index(prefix)
    assert len(db.seq_index) == 66

    # fetch through the facade: bytes must match the fasta truth
    (sid, slen) = db.seq_index[("RC_TEST", "test_agc_seqs")]
    want = truth[("test_agc_seqs", "RC_TEST")]
    assert slen == len(want)
    assert bytes(db.get_seq_by_id(sid)) == want
    assert bytes(db.get_sub_seq_by_id(sid, 100, 200)) == want[100:200]

    # query the index with one of the archived sequences: the top hit
    # must be the sequence itself, full length
    q = truth[("test_agc_ref", "NA21309#1#JAHEPC010000026.1:3279880-3319873")]
    hits = db.query_fragment_to_hps(
        bytearray(q), 0.25, max_count=32, max_count_query=32,
        max_count_target=32, max_aln_span=8,
    )
    assert hits, "query against AGC-backed index returned nothing"


def test_stream_archive_parallel_matches_sync(test_data_dir):
    """The prefetching reader pool yields the same records in the same
    order as synchronous decoding (thread-local handles, bounded
    prefetch window — core/archive_pipeline.py)."""
    import os

    from pgrtk.core.agc import open_archive
    from pgrtk.core.archive_pipeline import stream_archive

    path = os.path.join(test_data_dir, "test.agc")
    sync = open_archive(path)
    want = [
        (s, c, sync.get_seq(s, c))
        for s in sync.list_samples()
        for c, _l in sync.list_ctgs(s)
    ]
    got = [
        rec
        for chunk in stream_archive(
            path, chunk_contigs=2, nthreads=3, prefetch=2
        )
        for rec in chunk
    ]
    assert got == want and len(got) > 4


def test_agc_reader_survives_corrupt_input(tmp_path):
    """Bit-flipped / truncated .agc archives must raise clean Python
    exceptions, never crash — the reference's wrapper documents that
    corrupt AGC files segfault its C++ library (agc_io.rs:71-75); our
    reverse-engineered reader is bounds-checked."""
    import numpy as np

    from pgrtk.core.agc import open_archive

    src = "/root/reference/pgr-db/test/test_data/test.agc"
    data = bytearray(open(src, "rb").read())
    rng = np.random.default_rng(1)
    n_ok = n_raised = 0
    for trial in range(15):
        buf = bytearray(data)
        if trial % 4 == 0:
            buf = buf[: len(buf) // 2]
        else:
            for p in rng.integers(16, len(buf), size=6):
                buf[p] ^= 0xFF
        path = str(tmp_path / f"c{trial}.agc")
        with open(path, "wb") as f:
            f.write(bytes(buf))
        try:
            a = open_archive(path)
            for s in a.list_samples()[:1]:
                for ctg, _l in a.list_ctgs(s)[:2]:
                    a.get_sub_seq(s, ctg, 0, 200)
            n_ok += 1
        except Exception:
            n_raised += 1
    assert n_ok + n_raised == 15
    assert n_raised > 0


def test_agc_crafted_footer_counts_fail_cleanly(tmp_path):
    """Zstd-valid or footer-level crafted counts must be rejected before
    any allocation (the bit-flip test mostly dies in decompression and
    never reaches the parsers — the r4 frg lesson).  Huge n_parts and
    part sizes in a crafted footer must fail agc_open cleanly."""

    def varint(v):
        b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        return bytes([len(b)]) + b

    def cstr(s):
        return s.encode() + b"\x00"

    # footer claiming 2^60 parts for one stream
    foot = varint(1) + cstr("collection-main") + varint(1 << 60) + varint(0)
    p = tmp_path / "huge_parts.agc"
    p.write_bytes(b"\x00" * 64 + foot + len(foot).to_bytes(8, "little"))
    with pytest.raises(Exception):
        AgcFile(str(p))

    # plausible footer whose single part claims a 2^60-byte payload
    foot = (
        varint(2)
        + cstr("params") + varint(1) + varint(0)
        + varint(0) + varint(1 << 60)
        + cstr("collection-main") + varint(1) + varint(0)
        + varint(0) + varint(16)
    )
    p = tmp_path / "huge_part_size.agc"
    p.write_bytes(b"\x00" * 64 + foot + len(foot).to_bytes(8, "little"))
    with pytest.raises(Exception):
        AgcFile(str(p))
