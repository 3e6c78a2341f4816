"""Synthetic repeat-seeded corpus helpers for benchmarks and tests.

Perfect tandem repeats of SHORT units are systematically suppressed by
the reference sketch: mode-2 keeps ~1 mer per ~256 bases (hash <
u64::MAX >> 4 >> r, shmmrutils.rs:621), then the min_span/distinctness
filter drops any mer whose hash equals its previous OR next mer's hash
(`px != x && x != nx`, shmmrutils.rs:545-548) — a unit that keeps only
one mer per copy emits a run of equal hashes and vanishes entirely.  A
corpus that needs VISIBLE multiplicity (postings with per-(key, sid)
multiplicity == copies) must therefore verify its unit actually
survives; `pick_tandem_unit` draws deterministic candidates until one
does.
"""
from __future__ import annotations

import numpy as np

_BASES = b"ACGT"


def to_ascii(arr2bit: np.ndarray) -> bytes:
    """2-bit codes -> ACGT bytes (vectorized)."""
    return np.frombuffer(_BASES, dtype=np.uint8)[arr2bit].tobytes()


def tandem_pair_mults(seq2bit: np.ndarray, spec=None) -> dict:
    """Sketch a 2-bit sequence with the host arbiter and return
    {(k0, k1): occurrence_count} over its builder-canonical shimmer
    pairs (seq_db.rs:386-399 tie -> orientation 0)."""
    from collections import Counter

    from ..core import sketch as sketch_mod
    from ..core.spec import ShmmrSpec

    if spec is None:
        spec = ShmmrSpec(80, 56, 4, 64, True)
    mx, _my = sketch_mod.sequence_to_shmmrs_arrays(
        0, to_ascii(seq2bit), spec, False
    )
    if len(mx) < 2:
        return {}
    h = (mx >> np.uint64(8)).astype(np.uint64)
    s0, s1 = h[:-1], h[1:]
    swap = s0 > s1
    k0 = np.where(swap, s1, s0)
    k1 = np.where(swap, s0, s1)
    return Counter(zip(k0.tolist(), k1.tolist()))


def pick_tandem_unit(
    rng: np.random.Generator,
    unit_len: int,
    copies: int,
    flank: int = 2048,
    min_keys: int = 2,
    max_tries: int = 64,
) -> np.ndarray:
    """Draw a random 2-bit unit whose perfect `copies`-fold tandem keeps
    at least `min_keys` pair keys at full multiplicity == `copies` under
    the default sketch spec (w=80, k=56, r=4, min_span=64, sketch).

    Deterministic given the rng state.  Raises if no candidate survives
    within max_tries (expected ~1-3 tries at unit_len >= 2 kb)."""
    for _ in range(max_tries):
        unit = rng.integers(0, 4, size=unit_len, dtype=np.uint8)
        probe = np.concatenate(
            [
                rng.integers(0, 4, size=flank, dtype=np.uint8),
                np.tile(unit, copies),
                rng.integers(0, 4, size=flank, dtype=np.uint8),
            ]
        )
        mults = tandem_pair_mults(probe)
        n_full = sum(1 for c in mults.values() if c == copies)
        if n_full >= min_keys:
            return unit
    raise RuntimeError(
        f"no {unit_len}-base unit with visible x{copies} tandem "
        f"multiplicity found in {max_tries} tries"
    )


def mutate_snps(rng: np.random.Generator, seq2bit: np.ndarray, rate: float,
                keep=None) -> np.ndarray:
    """Copy of `seq2bit` with a Binomial(len, rate) set of substitutions;
    positions inside the half-open ranges of `keep` stay unchanged."""
    out = seq2bit.copy()
    n = rng.binomial(len(out), rate)
    pos = rng.choice(len(out), size=n, replace=False)
    for bgn, end in keep or ():
        pos = pos[(pos < bgn) | (pos >= end)]
    out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
    return out


def region_panel(
    seed: int,
    n_haps: int = 48,
    length: int = 4_000_000,
    n_queries: int = 16,
    query_len: tuple = (200_000, 1_000_000),
) -> dict:
    """A region panel of the kind PGR-tk is run on (HPRC haplotypes over
    an MHC-scale region): `n_haps` SNP-mutated copies of one `length`-base
    region at 1e-3, plus ROI queries cut from 4 held-out haplotypes.

    Every haplotype carries a shared 3-copy tandem of an 8 kb unit and a
    24 kb segmental duplication.  A 16-copy tandem of a 3 kb unit (the
    CNV block) is present in every 4th haplotype only; the others carry
    unrelated sequence there.  Tandem units are drawn with
    `pick_tandem_unit`, so their copies are visible to the sketch.  The
    held-out haplotypes carry the CNV, and query 0 covers it: its pair
    keys have in-query run length ~16 and per-(key, sid) multiplicity ~16,
    so the per-(pair, sid) count filter (max_count=128) fires there.  SNPs
    skip the CNV block so that firing does not depend on the seed.

    Returns dict(haps=[(name, 2-bit array)], queries=[(name, 2-bit
    array)], cnv=(bgn, end), cnv_haps=[indices]).
    """
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=length, dtype=np.uint8)
    u16, n16 = 3_072, 16
    cnv = (int(0.15 * length), int(0.15 * length) + u16 * n16)
    base[cnv[0]:cnv[1]] = np.tile(pick_tandem_unit(rng, u16, n16), n16)
    u3, n3 = 8_192, 3
    t3 = int(0.40 * length)
    base[t3:t3 + u3 * n3] = np.tile(pick_tandem_unit(rng, u3, n3), n3)
    sd_len = 24_576
    sd = rng.integers(0, 4, size=sd_len, dtype=np.uint8)
    for at in (int(0.60 * length), int(0.80 * length)):
        base[at:at + sd_len] = sd
    if max(cnv[1], t3 + u3 * n3, int(0.80 * length) + sd_len) > length:
        raise ValueError(f"region of {length} bases is too short")

    def hap(with_cnv: bool) -> np.ndarray:
        out = mutate_snps(rng, base, 1e-3, keep=[cnv])
        if not with_cnv:
            out[cnv[0]:cnv[1]] = rng.integers(
                0, 4, size=cnv[1] - cnv[0], dtype=np.uint8
            )
        return out

    cnv_haps = list(range(0, n_haps, 4))
    haps = [
        (f"HG{i:03d}", hap(i in cnv_haps)) for i in range(n_haps)
    ]
    held = [hap(True) for _ in range(4)]
    queries = []
    lo, hi = query_len
    for i in range(n_queries):
        qlen = int(rng.integers(lo, hi + 1))
        if i == 0:
            mid = (cnv[0] + cnv[1]) // 2
            bgn = min(max(0, mid - qlen // 2), length - qlen)
        else:
            bgn = int(rng.integers(0, length - qlen + 1))
        queries.append(
            (f"roi_{i:02d}", held[i % 4][bgn:bgn + qlen].copy())
        )
    return dict(haps=haps, queries=queries, cnv=cnv, cnv_haps=cnv_haps)


def write_fasta(path: str, records) -> None:
    """Write (name, 2-bit array) records as one-line FASTA."""
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n" + to_ascii(seq) + b"\n")
