"""Isolate the short-row sketch overhead: identical total bases, same
SK_KW, different row shapes.  Forces every output into the fold."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from pgrtk.ops import pairs as pairs_ops
    from pgrtk.ops import sketch as sketch_ops

    rng = np.random.default_rng(0)
    total = 8 * 1_048_576
    data = rng.integers(0, 4, size=total, dtype=np.uint8)
    SK = dict(slots=12, block2=512, slots2=192)

    def timed(shape, with_pairs):
        B, L = shape
        arr = jnp.asarray(data.reshape(B, L))
        lens = jnp.full((B,), L, dtype=jnp.int32)

        def once(seqs):
            xh, xl, yl, valid, ovf = sketch_ops.sketch_compact_mode2(
                seqs, lens, 56, 4, 64, 512, **SK
            )
            if with_pairs:
                keep = pairs_ops.min_span_filter_gapped(
                    xh, xl, yl, valid, 64
                )
                pr = pairs_ops.pair_mers_gapped(
                    xh, xl, yl, keep, tie_orientation_one=True
                )
                acc = jnp.uint32(0)
                for k in ("k0_hi", "k0_lo", "k1_hi", "k1_lo", "bgn",
                          "end", "orientation"):
                    acc += pr[k].astype(jnp.uint32).sum() & jnp.uint32(0xFFFF)
                acc += pr["pair_valid"].sum().astype(jnp.uint32)
                return acc + ovf.astype(jnp.uint32)
            acc = (
                xh.astype(jnp.uint32).sum() & jnp.uint32(0xFFFF)
            ) + (
                xl.astype(jnp.uint32).sum() & jnp.uint32(0xFFFF)
            ) + (
                yl.astype(jnp.uint32).sum() & jnp.uint32(0xFFFF)
            ) + valid.sum().astype(jnp.uint32)
            return acc + ovf.astype(jnp.uint32)

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
            int(chain_fn(arr, jnp.int32(30))[1])
            best = min(best, (time.time() - t0) / 30)
        return best

    for shape in ((8, 1_048_576), (32, 262_144), (128, 65_536)):
        for wp in (False, True):
            dt = timed(shape, wp)
            tag = "sketch+pairs" if wp else "sketch-only "
            print(
                f"{tag} {shape}: {dt*1e3:6.2f} ms  "
                f"{total/dt/1e6:7.1f} Mb/s",
                flush=True,
            )


if __name__ == "__main__":
    main()
