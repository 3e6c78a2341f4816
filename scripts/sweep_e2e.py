"""Config sweep of the full device e2e query step on the GPU.

Times query_e2e_step end-to-end (fold-synced, certified-flag configs
only — a config whose flags fire is reported DIRTY and its time is
meaningless) over a list of (QCHUNK, slots2, M, lookback, unroll)
configs on the bench corpus.  Use after scripts/profile_e2e.py pointed
at the stage to squeeze.

Run: python scripts/sweep_e2e.py from the repository root
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CONFIGS = [
    # (qchunk, slots2, M, lookback, unroll)
    (16, 192, 3, 24, 16),   # current bench config
    (32, 128, 3, 24, 16),
    (32, 112, 3, 24, 16),
    (32, 96, 3, 24, 16),
]


def main():
    import jax
    import jax.numpy as jnp

    from pgrtk.ops import query_e2e
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

    C = 8
    targets = np.stack([mutate(prng, drop16=(s != 0)) for s in range(C)])
    qhaps = np.stack([mutate(prng) for _ in range(B)])
    idx = query_e2e.build_index(
        targets, n_decoys=4_194_304, build_lookup=False, P=32
    )
    probe = idx["probe"]
    bits = int(probe["bits"])
    tables = tuple(
        jnp.asarray(x)
        for x in (
            probe["planes"][0], probe["planes"][1], probe["planes"][2],
            probe["planes"][3], probe["fence_rows"], idx["p_rows"],
        )
    )

    for qchunk, slots2, M, lookback, unroll in CONFIGS:
        queries = qhaps.reshape(B * qchunk, L // qchunk)
        BQ, LQ = queries.shape
        q_arr = jnp.asarray(queries)
        q_lens = jnp.full((BQ,), LQ, dtype=jnp.int32)
        kw = dict(
            probe_aligned=probe.get("aligned", False),
            slots2=slots2, lookback=lookback, unroll=unroll, M=M, P=32,
            sketch_compact=(12, 512, 192), pair_block=None,
        )

        def once(seqs, p0, p1, p2, p3, fence, prows):
            res = query_e2e.query_e2e_step(
                seqs, q_lens, bits, [p0, p1, p2, p3], fence, prows, C,
                **kw,
            )
            return query_e2e.fold_e2e_scalar(res)

        @jax.jit
        def certify(seqs, p0, p1, p2, p3, fence, prows):
            res = query_e2e.query_e2e_step(
                seqs, q_lens, bits, [p0, p1, p2, p3], fence, prows, C,
                **kw,
            )
            return (
                res["overflow"].astype(jnp.int32)
                + res["dup"].sum().astype(jnp.int32)
                + res["inexact"].sum().astype(jnp.int32)
                + res["row_ovf"].sum().astype(jnp.int32)
                + res["mult_ovf"].sum().astype(jnp.int32)
                + res["lane_ovf"].sum().astype(jnp.int32)
            )

        tag = (f"qchunk={qchunk} slots2={slots2} M={M} "
               f"W={lookback} unroll={unroll}")
        dirty = int(certify(q_arr, *tables))
        if dirty:
            print(f"{tag}: DIRTY ({dirty} flags)", flush=True)
            continue

        @jax.jit
        def chain_fn(seqs, n, *tbl):
            def body(_, carry):
                s, acc = carry
                a = once(s, *tbl)
                nxt = jnp.roll(
                    s, (a & jnp.uint32(3)).astype(jnp.int32), axis=0
                )
                return (nxt, acc + a)

            return jax.lax.fori_loop(
                jnp.int32(0), n, body, (seqs, jnp.uint32(0))
            )

        int(chain_fn(q_arr, jnp.int32(1), *tables)[1])
        int(chain_fn(q_arr, jnp.int32(1), *tables)[1])
        N = 30
        t0 = time.time()
        int(chain_fn(q_arr, jnp.int32(N), *tables)[1])
        dt = (time.time() - t0) / N
        print(
            f"{tag}: {dt * 1e3:6.2f} ms  {B * L / dt / 1e6:7.1f} Mb/s",
            flush=True,
        )


if __name__ == "__main__":
    main()
