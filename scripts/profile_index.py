"""Stage-level profile of the INDEX pipeline on the GPU (mirror of
profile_e2e.py for the bench's index stage: sketch+compact -> min_span
-> pair -> key sort on B=8 x 1M repeat-seeded rows)."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n_iters = int(sys.argv[1]) if len(sys.argv) > 1 else 30

    import jax
    import jax.numpy as jnp

    from pgrtk.ops import pairs as pairs_ops
    from pgrtk.ops import sketch as sketch_ops
    from pgrtk.utils import synth

    B, L = 8, 1_048_576
    QCB = 65_536
    S16, U16, N16 = 3 * QCB + 8_192, 3_072, 16
    E16 = S16 + U16 * N16
    S3, U3, N3 = 7 * QCB + 16_384, 8_192, 3
    SD1, SD2, SDL = 9 * QCB + 4_096, 13 * QCB + 4_096, 24_576
    prng = np.random.default_rng(2)
    base = prng.integers(0, 4, size=L, dtype=np.uint8)
    base[S16:E16] = np.tile(synth.pick_tandem_unit(prng, U16, N16), N16)
    base[S3:S3 + U3 * N3] = np.tile(
        synth.pick_tandem_unit(prng, U3, N3), N3
    )
    sd = prng.integers(0, 4, SDL, dtype=np.uint8)
    base[SD1:SD1 + SDL] = sd
    base[SD2:SD2 + SDL] = sd

    def mutate(rng, drop16=False):
        out = base.copy()
        if drop16:
            out[S16:E16] = rng.integers(0, 4, E16 - S16, dtype=np.uint8)
        n = rng.binomial(L, 1e-4)
        pos = rng.choice(L, size=n, replace=False)
        pos = pos[(pos < S16) | (pos >= E16)]
        out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
        return out

    targets = np.stack([mutate(prng, drop16=(s != 0)) for s in range(8)])
    arr = jnp.asarray(targets)
    lens = jnp.full((B,), L, dtype=jnp.int32)
    rids = jnp.arange(B, dtype=jnp.uint32)
    SK_KW = dict(slots=12, block2=512, slots2=192)

    def fold(*arrs):
        acc = jnp.uint32(0)
        for a in arrs:
            if a.dtype == jnp.bool_:
                acc = acc + a.sum().astype(jnp.uint32)
            else:
                acc = acc + (a.astype(jnp.uint32).sum() & jnp.uint32(0xFFFF))
        return acc

    def upto_sketch(seqs):
        xh, xl, yl, valid, ovf = sketch_ops.sketch_compact_mode2(
            seqs, lens, 56, 4, 64, 512, **SK_KW
        )
        return fold(xh, xl, yl, valid) + ovf.astype(jnp.uint32)

    def upto_pairs(seqs):
        xh, xl, yl, valid, ovf = sketch_ops.sketch_compact_mode2(
            seqs, lens, 56, 4, 64, 512, **SK_KW
        )
        keep = pairs_ops.min_span_filter_gapped(xh, xl, yl, valid, 64)
        pr = pairs_ops.pair_mers_gapped(xh, xl, yl, keep)
        return fold(*(pr[k] for k in (
            "k0_hi", "k0_lo", "k1_hi", "k1_lo", "bgn", "end",
            "orientation", "pair_valid",
        ))) + ovf.astype(jnp.uint32)

    def full(seqs):
        xh, xl, yl, valid, ovf = sketch_ops.sketch_compact_mode2(
            seqs, lens, 56, 4, 64, 512, **SK_KW
        )
        keep = pairs_ops.min_span_filter_gapped(xh, xl, yl, valid, 64)
        pr = pairs_ops.pair_mers_gapped(xh, xl, yl, keep)
        table = pairs_ops.sort_pairs(pr, rids)
        return (
            table["valid"].sum().astype(jnp.uint32)
            + (table["k0_lo"].sum() & jnp.uint32(3))
            + ovf.astype(jnp.uint32)
        )

    def timed(once):
        @jax.jit
        def chain_fn(seqs, n):
            def body(_, carry):
                s, acc = carry
                a = once(s)
                nxt = (s + (a & jnp.uint32(3)).astype(jnp.uint8)) % jnp.uint8(4)
                return (nxt, acc + a)

            return jax.lax.fori_loop(
                jnp.int32(0), n, body, (seqs, jnp.uint32(0))
            )

        int(chain_fn(arr, jnp.int32(1))[1])
        int(chain_fn(arr, jnp.int32(1))[1])
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            int(chain_fn(arr, jnp.int32(n_iters))[1])
            best = min(best, (time.time() - t0) / n_iters)
        return best

    total = B * L
    prev = 0.0
    for name, fn in (
        ("sketch+compact", upto_sketch),
        ("+min_span+pairs", upto_pairs),
        ("full(+sort)", full),
    ):
        dt = timed(fn)
        ms = dt * 1e3
        print(
            f"{name:16s} {ms:7.2f} ms  (+{ms - prev:6.2f})  "
            f"{total / dt / 1e6:8.1f} Mb/s",
            flush=True,
        )
        prev = ms


if __name__ == "__main__":
    main()
