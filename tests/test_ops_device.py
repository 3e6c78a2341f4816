"""Device (JAX) kernel exactness tests — run on the CPU backend with a
virtual 8-device mesh (see conftest); the same code path runs on the GPU."""
import os
import random

import numpy as np
import pytest

from pgrtk.core import sketch_ref
from pgrtk.core.fasta import read_fastx_all
from pgrtk.core.spec import ShmmrSpec


def test_u64_ops_random():
    import jax.numpy as jnp

    from pgrtk.ops import u64

    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 64, size=256, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, size=256, dtype=np.uint64)
    ja, jb = u64.from_numpy(a), u64.from_numpy(b)
    assert np.array_equal(u64.to_numpy(u64.add(ja, jb)), a + b)
    assert np.array_equal(u64.to_numpy(u64.xor(ja, jb)), a ^ b)
    assert np.array_equal(u64.to_numpy(u64.not_(ja)), ~a)
    for s in (0, 1, 8, 21, 24, 31, 32, 33, 55, 63):
        assert np.array_equal(
            u64.to_numpy(u64.shl_const(ja, s)), a << np.uint64(s)
        ), s
        assert np.array_equal(
            u64.to_numpy(u64.shr_const(ja, s)), a >> np.uint64(s)
        ), s
    shifts = rng.integers(0, 64, size=256).astype(np.uint32)
    assert np.array_equal(
        u64.to_numpy(u64.shl(ja, jnp.asarray(shifts))), a << shifts.astype(np.uint64)
    )
    assert np.array_equal(
        u64.to_numpy(u64.shr(ja, jnp.asarray(shifts))), a >> shifts.astype(np.uint64)
    )
    assert np.array_equal(np.asarray(u64.lt(ja, jb)), a < b)
    assert np.array_equal(np.asarray(u64.le(ja, jb)), a <= b)


def test_u64_wang_hash():
    from pgrtk.ops import u64

    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 64, size=512, dtype=np.uint64)
    expect = np.asarray(
        [sketch_ref.u64hash(int(v)) for v in a], dtype=np.uint64
    )
    got = u64.to_numpy(u64.wang_hash(u64.from_numpy(a)))
    assert np.array_equal(got, expect)


def test_device_sketch_mode2_exact(test_data_dir):
    from pgrtk.ops import sketch as dsk

    spec = ShmmrSpec(sketch=True)
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))[:12]
    seqs = [r.seq for r in recs]
    # adversarial extras: Ns, lowercase, short seqs, homopolymers
    seqs += [
        b"ACGTNNNNacgtACGTACGGTTACA" * 40,
        b"A" * 300,
        b"ACGT" * 20,
        b"",
        bytes(
            random.Random(3).choice(b"ACGTN") for _ in range(5000)
        ),
    ]
    out = dsk.sketch_mode2(seqs, spec=spec)
    for i, s in enumerate(seqs):
        ref = sketch_ref.sequence_to_shmmrs(i, s, spec)
        rx = np.asarray([m[0] for m in ref], dtype=np.uint64)
        ry = np.asarray([m[1] for m in ref], dtype=np.uint64)
        dx, dy = out[i]
        assert np.array_equal(rx, dx), f"seq {i} x mismatch"
        assert np.array_equal(ry, dy), f"seq {i} y mismatch"


def test_device_sketch_various_k_r(test_data_dir):
    from pgrtk.ops import sketch as dsk

    recs = read_fastx_all(os.path.join(test_data_dir, "test_rev.fa"))
    seqs = [r.seq for r in recs]
    for k, r, ms in ((56, 4, 64), (48, 2, 16), (33, 6, 0), (56, 1, 64)):
        spec = ShmmrSpec(w=80, k=k, r=r, min_span=ms, sketch=True)
        out = dsk.sketch_mode2(seqs, spec=spec)
        for i, s in enumerate(seqs):
            ref = sketch_ref.sequence_to_shmmrs(i, s, spec)
            rx = np.asarray([m[0] for m in ref], dtype=np.uint64)
            dx, _ = out[i]
            assert np.array_equal(rx, dx), (k, r, ms, i)


def test_fused_sketch_compact_matches_unfused():
    """sketch_compact_mode2 (scan-fused level-1 extraction) must produce
    the exact compact_mers_packed stream, mask short rows identically,
    and fold the overlap inexact flag into overflow."""
    import jax.numpy as jnp

    from pgrtk.ops import pairs as pairs_ops
    from pgrtk.ops import sketch as dsk

    rng = np.random.RandomState(5)
    B, L = 4, 1 << 16
    arr = rng.randint(0, 4, size=(B, L)).astype(np.uint8)
    arr[1, 5200:5210] = 10  # N run far from any chunk boundary
    lens = np.array([L, 40000, 512, 57], dtype=np.int32)
    for b, n in enumerate(lens):
        arr[b, n:] = 10
    ja, jl = jnp.asarray(arr), jnp.asarray(lens)
    rids = jnp.arange(B, dtype=jnp.uint32)

    out = dsk.sketch_mode2_dense(ja, jl, rids, 56, 4, 64, 512)
    assert not bool(out["inexact"])
    xh0, xl0, yl0, v0, o0 = pairs_ops.compact_mers_packed(
        out["x_hi"], out["x_lo"], out["y_lo"], out["selected"]
    )
    xh1, xl1, yl1, v1, o1 = dsk.sketch_compact_mode2(ja, jl, 56, 4, 64, 512)
    assert bool(o0) == bool(o1) == False
    va = np.asarray(v0)
    assert np.array_equal(va, np.asarray(v1))
    for a, b in ((xh0, xh1), (xl0, xl1), (yl0, yl1)):
        assert np.array_equal(np.asarray(a)[va], np.asarray(b)[va])
    assert va.sum() > 100

    # an N run straddling a chunk boundary must surface in the fused
    # overflow flag (the unfused path reports it as `inexact`)
    arr2 = rng.randint(0, 4, size=(B, L)).astype(np.uint8)
    arr2[0, 1000:1100] = 10
    jl2 = jnp.full((B,), L, dtype=jnp.int32)
    d = dsk.sketch_mode2_dense(jnp.asarray(arr2), jl2, rids, 56, 4, 64, 512)
    f = dsk.sketch_compact_mode2(jnp.asarray(arr2), jl2, 56, 4, 64, 512)
    assert bool(d["inexact"]) and bool(f[4])


def test_sketch_mode2_wrapper_overflow_fallback_exact():
    """sketch_mode2 (host API) must fall back to the exact dense path
    when the fused compaction overflows — a dense periodic repeat (16
    selected in one 512 window) — and still match the scalar arbiter."""
    from pgrtk.core import sketch_ref
    from pgrtk.core.spec import ShmmrSpec
    from pgrtk.ops import sketch as dsk

    motif = [0, 0, 1, 2, 0, 0, 0, 2, 0, 0, 1]  # AACGAAAGAAC, phase-4 low hash
    rng = np.random.RandomState(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    row = rng.randint(0, 4, size=4096).astype(np.uint8)
    run = (motif * 24)[: 56 + 14 * 11]
    row[1088 : 1088 + len(run)] = run
    seqs = [bases[row].tobytes(), bases[rng.randint(0, 4, 2000)].tobytes()]

    spec = ShmmrSpec(sketch=True)
    got = dsk.sketch_mode2(seqs, spec=spec)
    for sid, s in enumerate(seqs):
        exp = sketch_ref.sequence_to_shmmrs(sid, s, spec)
        xs = np.asarray([m[0] for m in exp], dtype=np.uint64)
        ys = np.asarray([m[1] for m in exp], dtype=np.uint64)
        assert np.array_equal(got[sid][0], xs), f"x mismatch sid={sid}"
        assert np.array_equal(got[sid][1], ys), f"y mismatch sid={sid}"
