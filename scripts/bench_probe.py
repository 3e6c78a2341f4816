"""Micro-benchmark: flat-fence vs row-fence vs fused-planes probe
layouts on the GPU.

Bench-scale shapes: 4M-key table, BQ*Pc = 128*224 = 28,672 query keys
per step (the e2e pipeline's probe load).  fence_to_rows is the
production layout; none of the three is yet measured on the H100.

Run: python scripts/bench_probe.py (one process per card).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from pgrtk.ops import probe

    n_iters = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    N, Q = 4_194_304, 128 * 224
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 56, size=(N, 2), dtype=np.uint64)
    keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
    t = probe.build_probe_table_dense(keys)
    qk = np.concatenate(
        [
            keys[rng.integers(0, N, Q // 2)],
            rng.integers(0, 1 << 56, size=(Q - Q // 2, 2), dtype=np.uint64),
        ]
    )
    qs = tuple(
        jnp.asarray(v.astype(np.uint32))
        for v in (
            qk[:, 0] >> np.uint64(32), qk[:, 0] & np.uint64(0xFFFFFFFF),
            qk[:, 1] >> np.uint64(32), qk[:, 1] & np.uint64(0xFFFFFFFF),
        )
    )
    planes = tuple(jnp.asarray(t["planes"][i]) for i in range(4))
    bits = t["bits"]

    def timed(fence):
        @jax.jit
        def chain_fn(h0, l0, h1, l1, n, p0, p1, p2, p3, f):
            def body(_, carry):
                a, acc = carry
                tab = dict(bits=bits, planes=[p0, p1, p2, p3], fence=f)
                fo, r = probe.probe_keys_dense(tab, a, l0, h1, l1)
                s = (
                    fo.sum().astype(jnp.uint32)
                    + (r.sum().astype(jnp.uint32) & jnp.uint32(0xFFFF))
                )
                return (h0 ^ (s & jnp.uint32(1)), acc + s)

            return jax.lax.fori_loop(
                jnp.int32(0), n, body, (h0, jnp.uint32(0))
            )[1]

        args = qs + (jnp.int32(1),) + planes + (fence,)
        int(chain_fn(*args))
        int(chain_fn(*args))
        t0 = time.time()
        int(chain_fn(*(qs + (jnp.int32(n_iters),) + planes + (fence,))))
        return (time.time() - t0) / n_iters

    dt_flat = timed(jnp.asarray(t["fence"]))
    dt_rows = timed(jnp.asarray(t["fence_rows"]))

    # aligned layout: one row fetch per plane
    ta = probe.build_probe_table_aligned(keys)
    a_planes = tuple(jnp.asarray(ta["planes"][i]) for i in range(4))

    def timed_aligned(fence):
        @jax.jit
        def chain_fn(h0, l0, h1, l1, n, p0, p1, p2, p3, f):
            def body(_, carry):
                a, acc = carry
                tab = dict(bits=ta["bits"], planes=[p0, p1, p2, p3],
                           fence=f)
                fo, r = probe.probe_keys_aligned(tab, a, l0, h1, l1)
                s = (
                    fo.sum().astype(jnp.uint32)
                    + (r.sum().astype(jnp.uint32) & jnp.uint32(0xFFFF))
                )
                return (h0 ^ (s & jnp.uint32(1)), acc + s)

            return jax.lax.fori_loop(
                jnp.int32(0), n, body, (h0, jnp.uint32(0))
            )[1]

        args = qs + (jnp.int32(1),) + a_planes + (fence,)
        int(chain_fn(*args))
        int(chain_fn(*args))
        t0 = time.time()
        int(chain_fn(*(qs + (jnp.int32(n_iters),) + a_planes + (fence,))))
        return (time.time() - t0) / n_iters

    dt_alg = timed_aligned(jnp.asarray(ta["fence_rows"]))
    for name, dt in (("flat fence", dt_flat), ("row fence", dt_rows),
                     ("aligned", dt_alg)):
        print(
            f"{name:12s} {dt*1e6:8.1f} us/step  {dt/Q*1e9:6.1f} ns/key",
            flush=True,
        )
    print(f"rows vs flat: {dt_flat/dt_rows:.2f}x; "
          f"aligned vs rows: {dt_rows/dt_alg:.2f}x "
          f"(padding {ta['n_padded']/ta['n']:.3f}x)", flush=True)


if __name__ == "__main__":
    main()
