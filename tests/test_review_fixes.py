"""Regression tests for the round-2 review findings: parity of the
public helpers, lazy-mdb fallback, WFA batch chunking, and the
principal-GFA write guard."""
import os

import numpy as np
import pytest

import pgrtk
from pgrtk.core import mdb
from pgrtk.core.agc_ref import _read_pvarint


@pytest.fixture(scope="module")
def amy_db(test_data_dir):
    db = pgrtk.SeqIndexDB()
    db.load_from_fastx(os.path.join(test_data_dir, "test_seqs.fa"))
    return db


def test_merge_regions_drops_foreign_orientations():
    # reference filters r[3]==0 / r[3]==1; anything else vanishes
    rgns = [
        (0, 100, 100, 0, [("a",)]),
        (50, 220, 170, 2, [("x",)]),   # dropped, not IndexError
        (150, 400, 250, 0, [("b",)]),
        (10, 90, 80, -1, [("y",)]),    # dropped, not reverse strand
    ]
    out = pgrtk.merge_regions(list(rgns), tol=1000)
    assert len(out) == 1
    assert out[0][0] == 0 and out[0][1] == 400
    assert out[0][2] == 350  # summed member lengths
    assert all(r[3] == 0 for r in out)


def test_diffusion_entropy_counts_distinct_linked_nodes(tmp_path):
    # ids {0,1,2} contiguous: n = 3, entropy finite
    gfa = tmp_path / "ok.gfa"
    gfa.write_text(
        "H\tVN:Z:1.0\n"
        "L\t0\t+\t1\t+\t0M\tSC:i:2\n"
        "L\t1\t+\t2\t+\t0M\tSC:i:3\n"
    )
    ent, weights = pgrtk.compute_graph_diffusion_entropy(str(gfa))
    assert np.isfinite(ent) and len(weights) == 3

    # ids {0,2} with a gap: the reference indexes a len(adj)-sized
    # matrix by raw id and raises IndexError — so must we
    gfa2 = tmp_path / "gap.gfa"
    gfa2.write_text("H\tVN:Z:1.0\nL\t0\t+\t2\t+\t0M\tSC:i:1\n")
    with pytest.raises(IndexError):
        pgrtk.compute_graph_diffusion_entropy(str(gfa2))

    # max_nodes compares the DISTINCT linked-node count
    assert pgrtk.compute_graph_diffusion_entropy(
        str(gfa), max_nodes=2
    ) is None


def test_principal_gfa_written_when_cutoff_filters_all(amy_db, tmp_path):
    out = tmp_path / "p.gfa"
    # cutoff far above any walk path length: decomposition is empty but
    # the file must still be written (downstream tooling opens it)
    amy_db.generate_principal_mapg_gfa(2, 10**9, str(out))
    assert out.exists()
    assert out.read_text().startswith("H\t")


def test_pvarint_five_extra_byte_branch():
    # b0 in [0xF8, 0xFF] carries 5 payload bytes with base 0x0810204080
    buf = bytes([0xF8, 0, 0, 0, 0, 0])
    v, p = _read_pvarint(buf, 0)
    assert v == 0x0810204080 and p == 6
    buf = bytes([0xF9, 0x01, 0x02, 0x03, 0x04, 0x05])
    v, p = _read_pvarint(buf, 0)
    assert v == (0x1 << 40 | 0x0102030405) + 0x0810204080 and p == 6
    # the 4-extra-byte branch is unchanged
    v, p = _read_pvarint(bytes([0xF0, 0, 0, 0, 0]), 0)
    assert v == 0x10204080 and p == 5


def test_scan_python_matches_native(tmp_path, test_data_dir):
    path = os.path.join(test_data_dir, "test_seqs_frag.mdb")
    from pgrtk.native import api as native

    if not native.available():
        pytest.skip("native runtime unavailable")
    spec_n, keys_n, starts_n, counts_n = native.mdb_scan(path)
    spec_p, keys_p, starts_p, counts_p = mdb._scan_python(path)
    assert spec_n == spec_p
    assert np.array_equal(keys_n, keys_p)
    assert np.array_equal(starts_n, starts_p)
    assert np.array_equal(counts_n, counts_p)


def test_batch_wfa_align_chunk_boundaries():
    from pgrtk.core.wfa import wfa_align_bases
    from pgrtk.ops.wfa import batch_wfa_align

    rng = np.random.RandomState(7)
    pairs = []
    for i in range(10):
        t = rng.choice(list(b"ACGT"), size=60 + i).astype(np.uint8)
        q = t.copy()
        q[10 + i] = ord("T") if q[10 + i] != ord("T") else ord("C")
        pairs.append((t.tobytes(), q.tobytes()))
    got = batch_wfa_align(pairs, chunk=4)  # forces 3 device chunks
    for (t, q), res in zip(pairs, got):
        exp = wfa_align_bases(t.decode(), q.decode(), 384, 3, 3, 1)
        assert res == exp


def test_u64pair_ordering_and_guards():
    """The complex128-view ordering must equal integer lexicographic
    order across the 56-bit range, and the guard must reject values in
    the f64 NaN/sign pattern range."""
    from pgrtk.utils.u64pair import cols_ckeys, pair_ckeys

    rng = np.random.RandomState(0)
    n = 4096
    pairs = rng.randint(0, 1 << 56, size=(n, 2)).astype(np.uint64)
    # force duplicates and boundary values
    pairs[0] = (0, 0)
    pairs[1] = ((1 << 56) - 1, (1 << 56) - 1)
    pairs[2] = pairs[3]
    ck = pair_ckeys(pairs)
    order_c = np.argsort(ck, kind="stable")
    order_l = np.lexsort((pairs[:, 1], pairs[:, 0]))
    assert np.array_equal(
        pairs[order_c], pairs[order_l]
    ), "complex order != lexicographic order"

    # column variant agrees with the row variant
    ck2 = cols_ckeys(pairs[:, 0], pairs[:, 1])
    assert np.array_equal(ck, ck2)

    # non-contiguous input still works (helper copies)
    ck3 = pair_ckeys(np.ascontiguousarray(pairs[::2]))
    assert np.array_equal(ck3, ck[::2])

    # guard fires for values at/above the f64 special-pattern floor
    bad = pairs.copy()
    bad[5, 0] = np.uint64(0x7FF0000000000001)
    with pytest.raises(AssertionError):
        pair_ckeys(bad)
