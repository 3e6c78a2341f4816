"""In-suite slice of the randomized reader fuzz sweep.

scripts/fuzz_readers.py drives thousands of random corruptions per
format (summary in docs/FUZZ_SWEEP.json); this keeps a small
deterministic slice in CI so a hardening regression in any binary
reader (Python or native) fails the suite, not just the script.
Every trial must end in Python control — success or exception; a
native crash aborts pytest itself (that IS the signal), a hang trips
the per-trial alarm and fails the assertion.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import fuzz_readers  # noqa: E402


@pytest.mark.parametrize("fmt", fuzz_readers.FORMATS)
def test_fuzz_slice(fmt):
    r = fuzz_readers._run_trials(fmt, seed0=500_000, n=40)
    assert r["hung"] == [], r
    assert r["ok"] + r["raised"] == 40
    # the corpus mutator must actually be corrupting: at least one
    # trial per format has to raise across 40 corruptions — except
    # plain fasta, whose parser (like the reference's) accepts any
    # text as records, so corrupted text still parses
    if fmt != "fasta":
        assert r["raised"] > 0, r
