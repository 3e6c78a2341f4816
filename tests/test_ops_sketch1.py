"""Device mode-1 (windowed minimizer) sketch vs the sequential arbiter."""
import os
import random

import pytest

from pgrtk.core import sketch_ref
from pgrtk.core.fasta import read_fastx_all
from pgrtk.core.spec import ShmmrSpec
from pgrtk.native import api as native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable"
)


def _seqs(test_data_dir):
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))[:8]
    rng = random.Random(3)
    seqs = [r.seq for r in recs]
    seqs += [bytes(rng.choice(b"ACGTN") for _ in range(2500)) for _ in range(2)]
    seqs += [bytes(rng.choice(b"ACGT") for _ in range(300))]  # short: fallback
    # tandem repeats: identical k-mers recur inside every w-window, so
    # the rightmost-tie argmin and strict-vs-<= expiry paths are
    # exercised on exact hash ties
    seqs += [b"ACGGTTACGAT" * 250, b"ACGTTGCAATCGGATCGTTAAC" * 120]
    return seqs


@pytest.mark.parametrize(
    "spec",
    [
        ShmmrSpec(w=80, k=56, r=4, min_span=64, sketch=False),
        ShmmrSpec(w=48, k=56, r=4, min_span=12, sketch=False),
        ShmmrSpec(w=33, k=33, r=1, min_span=0, sketch=False),
    ],
    ids=["default", "pbundle", "consensus"],
)
def test_device_mode1_exact(test_data_dir, spec):
    from pgrtk.ops import sketch1

    seqs = _seqs(test_data_dir)
    out = sketch1.sketch_mode1(seqs, spec=spec)
    for i, s in enumerate(seqs):
        assert out[i] == sketch_ref.sequence_to_shmmrs(i, s, spec), i


def test_reduce_and_filter_native_matches_reference():
    rng = random.Random(9)
    mers = []
    pos = 60
    for _ in range(300):
        pos += rng.randrange(1, 120)
        mers.append(
            (rng.randrange(1 << 56) << 8 | 56, pos << 1 | rng.randrange(2))
        )
    for r, ms, padding in ((4, 64, False), (2, 10, True), (1, 0, False)):
        ref = sketch_ref._min_span_filter(
            sketch_ref.reduce_shmmr(
                sketch_ref.reduce_shmmr(mers, r, padding), r, padding
            )
            if r > 1
            else mers,
            ms,
        )
        got = native.reduce_and_filter(mers, r, ms, padding)
        assert got == ref, (r, ms, padding)
