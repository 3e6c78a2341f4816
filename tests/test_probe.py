"""Bucketed probe-table tests (ops/probe.py)."""
import numpy as np


def _planes(q):
    import jax.numpy as jnp

    return (
        jnp.asarray((q[:, 0] >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((q[:, 0] & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((q[:, 1] >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((q[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def test_probe_membership_and_rows():
    import jax.numpy as jnp

    from pgrtk.ops import probe as PR

    rng = np.random.default_rng(0)
    N, Q = 1 << 14, 1 << 11
    keys = np.unique(
        rng.integers(0, 1 << 56, (N, 2)).astype(np.uint64), axis=0
    )
    keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
    t = PR.build_probe_table(keys)
    tbl = dict(
        bits=t["bits"],
        planes=[jnp.asarray(t["planes"][i]) for i in range(4)],
        row=jnp.asarray(t["row"]),
    )
    present_rows = rng.integers(0, len(keys), Q // 2)
    absent = rng.integers(0, 1 << 56, (Q - Q // 2, 2)).astype(np.uint64)
    q = np.concatenate([keys[present_rows], absent])
    found, row = PR.probe_keys(tbl, *_planes(q))
    found, row = np.asarray(found), np.asarray(row)

    key_set = {tuple(k) for k in keys.tolist()}
    exp_found = np.array([tuple(k) in key_set for k in q.tolist()])
    assert (found == exp_found).all()
    assert (row[: Q // 2][found[: Q // 2]] ==
            present_rows[found[: Q // 2]]).all()
    f2 = np.asarray(PR.probe_found(tbl, *_planes(q)))
    assert (f2 == exp_found).all()


def test_probe_handles_duplicate_keys():
    import jax.numpy as jnp

    from pgrtk.ops import probe as PR

    rng = np.random.default_rng(1)
    base = rng.integers(0, 1 << 56, (256, 2)).astype(np.uint64)
    keys = np.repeat(base, 3, axis=0)
    keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
    t = PR.build_probe_table(keys, avg_per_bucket=16)
    tbl = dict(
        bits=t["bits"],
        planes=[jnp.asarray(t["planes"][i]) for i in range(4)],
        row=jnp.asarray(t["row"]),
    )
    found, row = PR.probe_keys(tbl, *_planes(base))
    assert bool(np.asarray(found).all())
    # first-occurrence row: the key at that row matches the query
    r = np.asarray(row)
    assert (keys[r] == base).all()


def test_dense_fence_table_matches_padded_layout():
    """build_probe_table_dense (~1.0x key-array memory, no row plane)
    must return the same (found, row) as the padded-bucket layout,
    including duplicate keys (first-occurrence row) and misses."""
    import jax.numpy as jnp

    from pgrtk.ops import probe

    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 56, size=(100_000, 2), dtype=np.uint64)
    keys[500] = keys[501] = keys[502]  # duplicate run
    keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
    t_old = probe.build_probe_table(keys)
    t_new = probe.build_probe_table_dense(keys)
    told = dict(
        bits=t_old["bits"],
        planes=[jnp.asarray(t_old["planes"][i]) for i in range(4)],
        row=jnp.asarray(t_old["row"]),
    )
    tnew = dict(
        bits=t_new["bits"],
        planes=[jnp.asarray(t_new["planes"][i]) for i in range(4)],
        fence=jnp.asarray(t_new["fence"]),
    )
    qk = np.concatenate(
        [
            keys[rng.integers(0, len(keys), 3000)],
            rng.integers(0, 1 << 56, size=(3000, 2), dtype=np.uint64),
        ]
    )
    qs = [
        jnp.asarray(v.astype(np.uint32))
        for v in (
            qk[:, 0] >> np.uint64(32), qk[:, 0] & np.uint64(0xFFFFFFFF),
            qk[:, 1] >> np.uint64(32), qk[:, 1] & np.uint64(0xFFFFFFFF),
        )
    ]
    f1, r1 = probe.probe_keys(told, *qs)
    f2, r2 = probe.probe_keys_dense(tnew, *qs)
    assert np.array_equal(np.asarray(f1), np.asarray(f2))
    assert np.array_equal(np.asarray(r1), np.asarray(r2))
    mem_old = t_old["planes"].nbytes + t_old["row"].nbytes
    mem_new = t_new["planes"].nbytes + t_new["fence"].nbytes
    assert mem_new <= 1.2 * keys.nbytes  # the layout's whole point
    assert mem_new < mem_old / 2


def test_dense_overflow_raises_and_padded_fallback_works():
    """A pathological key set (one hot bucket) must raise ValueError in
    the dense build, while build_probe_table absorbs it by widening W —
    the fallback pair device_query relies on."""
    import pytest

    from pgrtk.ops import probe

    rng = np.random.default_rng(5)
    # 400 keys sharing the same top-14 hash0 bits -> one bucket > 128
    hot = (np.uint64(0x1234) << np.uint64(42)) | rng.integers(
        0, 1 << 42, size=400, dtype=np.uint64
    )
    keys = np.stack(
        [hot, rng.integers(0, 1 << 56, size=400, dtype=np.uint64)], axis=1
    )
    extra = rng.integers(0, 1 << 56, size=(20000, 2), dtype=np.uint64)
    keys = np.concatenate([keys, extra])
    keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
    with pytest.raises(ValueError):
        probe.build_probe_table_dense(keys)
    t = probe.build_probe_table(keys)  # widens W instead
    assert t["planes"].shape[2] >= 256


def test_fence_rows_layout_matches_scalar_fence():
    """probe_keys_dense with the fence_to_rows 2-D fence (row fetch +
    arithmetic lane select instead of a scalar gather) must return
    exactly the flat-fence (found, row)."""
    import jax.numpy as jnp

    from pgrtk.ops import probe

    rng = np.random.default_rng(9)
    keys = rng.integers(0, 1 << 56, size=(120_000, 2), dtype=np.uint64)
    keys[77] = keys[78]  # duplicate pair
    keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
    t = probe.build_probe_table_dense(keys)
    assert t["fence_rows"].shape[1] == 128
    td = dict(
        bits=t["bits"],
        planes=[jnp.asarray(t["planes"][i]) for i in range(4)],
        fence=jnp.asarray(t["fence"]),
    )
    tr = dict(
        bits=t["bits"],
        planes=td["planes"],
        fence=jnp.asarray(t["fence_rows"]),
    )
    qk = np.concatenate(
        [
            keys[rng.integers(0, len(keys), 4000)],
            rng.integers(0, 1 << 56, size=(4000, 2), dtype=np.uint64),
        ]
    )
    qs = [
        jnp.asarray(v.astype(np.uint32))
        for v in (
            qk[:, 0] >> np.uint64(32), qk[:, 0] & np.uint64(0xFFFFFFFF),
            qk[:, 1] >> np.uint64(32), qk[:, 1] & np.uint64(0xFFFFFFFF),
        )
    ]
    f1, r1 = probe.probe_keys_dense(td, *qs)
    f2, r2 = probe.probe_keys_dense(tr, *qs)
    assert np.array_equal(np.asarray(f1), np.asarray(f2))
    assert np.array_equal(np.asarray(r1), np.asarray(r2))
