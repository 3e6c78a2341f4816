"""Batched device WFA vs the native arbiter (wfa.cc) — bit-exact gapped
strings, SV-pipeline penalties (x=3, o=3, e=1, max_wf_length=384)."""
import numpy as np
import pytest

from pgrtk.core import wfa as host_wfa


def _mutate(rng, seq, n_snp=0, n_ins=0, n_del=0):
    s = bytearray(seq)
    bases = b"ACGT"
    for _ in range(n_snp):
        p = rng.randint(16, len(s) - 16)
        s[p] = bases[(bases.index(s[p]) + 1 + rng.randint(3)) % 4]
    for _ in range(n_ins):
        p = rng.randint(16, len(s) - 16)
        frag = bytes(rng.choice(np.frombuffer(bases, np.uint8),
                                rng.randint(1, 30)).tolist())
        s[p:p] = frag
    for _ in range(n_del):
        p = rng.randint(16, len(s) - 16 - 30)
        del s[p : p + rng.randint(1, 30)]
    return bytes(s)


def _rand_seq(rng, n):
    return bytes(
        rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tolist()
    )


def _pairs(seed=0):
    rng = np.random.RandomState(seed)
    pairs = []
    for i in range(12):
        n = int(rng.randint(40, 480))
        t = _rand_seq(rng, n)
        q = _mutate(
            rng, t,
            n_snp=int(rng.randint(0, 6)),
            n_ins=int(rng.randint(0, 3)),
            n_del=int(rng.randint(0, 3)),
        )
        pairs.append((t, q))
    # identical pair, single-SNP pair, pure-indel pair
    t = _rand_seq(rng, 100)
    pairs.append((t, t))
    q = bytearray(t); q[50] = b"A"[0] if t[50] != b"A"[0] else b"C"[0]
    pairs.append((t, bytes(q)))
    pairs.append((t, t[:40] + t[60:]))  # 20-base deletion
    pairs.append((t[:40] + t[60:], t))  # 20-base insertion
    return pairs


def test_batch_wfa_matches_native_arbiter():
    from pgrtk.ops import wfa as dwfa

    pairs = _pairs()
    got = dwfa.batch_wfa_align(pairs)
    for i, (t, q) in enumerate(pairs):
        want = host_wfa.wfa_align_bases(
            t.decode(), q.decode(), 384, 3, 3, 1, 1024
        )
        assert got[i] == want, i


def test_batch_wfa_reversed_segments_variant_parity():
    """The SV pipeline aligns REVERSED suffixes (left-aligned variants):
    device batch must reproduce get_variant_segments exactly."""
    from pgrtk.ops import wfa as dwfa

    rng = np.random.RandomState(3)
    cases = []
    for _ in range(6):
        t = _rand_seq(rng, int(rng.randint(60, 400)))
        q = _mutate(rng, t, n_snp=2, n_ins=1, n_del=1)
        cases.append((t, q))
    # the host reference result
    want = [
        host_wfa.get_variant_segments(t, q, 1, 384, 3, 3, 1)
        for t, q in cases
    ]
    rev_pairs = [(t[1:][::-1], q[1:][::-1]) for t, q in cases]
    aligned = dwfa.batch_wfa_align(rev_pairs)
    for i, ((t, q), res) in enumerate(zip(cases, aligned)):
        assert res is not None
        t_aln, q_aln = res
        pairs_map = host_wfa.wfa_aln_pair_map(t_aln, q_aln)
        r_t = t[1:][::-1]
        r_q = q[1:][::-1]
        for delta in range(1):
            pairs_map.append((len(r_t) + delta, len(r_q) + delta, "M"))
        t_len_m1 = 1 + len(r_t) - 1
        q_len_m1 = 1 + len(r_q) - 1
        pairs_map = [
            (t_len_m1 - tp, q_len_m1 - qp, c) for tp, qp, c in pairs_map
        ]
        pairs_map.reverse()
        got = host_wfa.get_variants_from_aln_pair_map(
            pairs_map, t.decode(), q.decode()
        )
        assert got == want[i], i


def test_batch_wfa_oversize_falls_back_to_host():
    from pgrtk.ops import wfa as dwfa

    rng = np.random.RandomState(5)
    t = _rand_seq(rng, 700)  # > L=512 -> host path
    q = _mutate(rng, t, n_snp=3)
    got = dwfa.batch_wfa_align([(t, q)])
    want = host_wfa.wfa_align_bases(t.decode(), q.decode(), 384, 3, 3, 1)
    assert got[0] == want


def test_sv_snapshot_through_device_wfa(test_data_dir, tmp_path, monkeypatch):
    """The SV pipeline's .alnmap/.vcf snapshot must be identical when the
    gap segments are aligned by the device batch kernel."""
    import os

    from pgrtk.cli import pgr_get_sv_candidate_regions as sv
    from pgrtk.core.fasta import read_fastx_all
    from pgrtk.utils import dispatch

    monkeypatch.setattr(
        dispatch, "use_device",
        lambda *a, **kw: kw.get("what") == "wfa",
    )
    recs = read_fastx_all(
        os.path.join(test_data_dir, "test_agc_seqs.fa")
    )[:3]
    qf = tmp_path / "q3.fa"
    with open(qf, "w") as f:
        for r in recs:
            f.write(f">{r.id.decode()}\n{r.seq.decode()}\n")
    sv.main(
        [
            os.path.join(test_data_dir, "test_agc_ref.fa"),
            str(qf),
            str(tmp_path / "sv"),
        ]
    )
    golden = os.path.join(os.path.dirname(__file__), "goldens")
    for name in ("sv.alnmap", "sv.vcf"):
        got = open(tmp_path / name).read()
        expect = open(os.path.join(golden, name)).read()
        assert got == expect, name


def test_batch_wfa_high_divergence_exercises_trim():
    """~80 SNPs -> score ~240: the wavefront grows past max_wf_length=384
    and the arbiter's adaptive trim kicks in; the device kernel must
    replicate it (mask + lo/hi tracking) bit-exactly."""
    from pgrtk.ops import wfa as dwfa

    rng = np.random.RandomState(11)
    t = _rand_seq(rng, 480)
    q = _mutate(rng, t, n_snp=80)
    got = dwfa.batch_wfa_align([(t, q)], S_max=256)
    want = host_wfa.wfa_align_bases(t.decode(), q.decode(), 384, 3, 3, 1)
    # if the device ran out of S_max it must have fallen back — either
    # way the output matches the arbiter
    assert got[0] == want
    # also check a score definitely within S_max (fewer SNPs, still wide)
    q2 = _mutate(rng, t, n_snp=66)
    got2 = dwfa.batch_wfa_align([(t, q2)], S_max=256)
    want2 = host_wfa.wfa_align_bases(t.decode(), q2.decode(), 384, 3, 3, 1)
    assert got2[0] == want2


def test_banded_extend_adversarial_indels_bit_exact():
    """The banded extend (round-3: per-step (band_w x band_l) run-length
    window instead of the full plane) must stay bit-exact through big
    indels and unrelated pairs — rows whose offsets spread past the band
    raise band_overflow and fall back to the host path transparently."""
    import numpy as np

    from pgrtk.core import wfa as host_wfa
    from pgrtk.ops import wfa as dev_wfa

    rng = np.random.RandomState(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for i in range(24):
        n = int(rng.randint(50, 500))
        t = bytes(rng.choice(bases, n).tolist())
        s = bytearray(t)
        mode = i % 4
        if mode == 0:  # SNPs
            for _ in range(rng.randint(1, 8)):
                p = rng.randint(0, len(s))
                s[p] = bases[rng.randint(4)]
        elif mode == 1 and len(s) > 120:  # big deletion
            p = rng.randint(10, len(s) - 110)
            del s[p : p + rng.randint(50, 100)]
        elif mode == 2:  # big insertion
            p = rng.randint(0, len(s))
            s[p:p] = bytes(rng.choice(bases, rng.randint(50, 150)).tolist())
        else:  # unrelated
            s = bytearray(
                bytes(rng.choice(bases, rng.randint(50, 400)).tolist())
            )
        pairs.append((t, bytes(s)))
    out_dev = dev_wfa.batch_wfa_align(pairs, chunk=32)
    out_host = [
        host_wfa.wfa_align_bases(t.decode(), q.decode(), 384, 3, 3, 1)
        for t, q in pairs
    ]
    assert out_dev == out_host


def test_batch_wfa_non_pow2_segment_cap():
    """The crossover sweep sizes L to the padded segment length (e.g.
    296 = 256 + 32 + 8), which is not a power of two — the shifted-query
    plane doubling must slice back to exactly L shifts (regression: it
    used to emit next_pow2(L) rows per side and crash the match mask)."""
    from pgrtk.ops import wfa as dwfa

    pairs = _pairs(seed=7)
    got = dwfa.batch_wfa_align(pairs, L=296, chunk=8, S_max=512)
    for i, (t, q) in enumerate(pairs):
        want = host_wfa.wfa_align_bases(
            t.decode(), q.decode(), 384, 3, 3, 1, 1024
        )
        assert got[i] == want, i
