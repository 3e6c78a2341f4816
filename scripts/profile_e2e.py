"""Stage-level profiling of the device end-to-end query pipeline on the
GPU.  Times cumulative prefixes of the pipeline (each prefix forces
ALL stage outputs into the fold — round-3 lesson: DCE hides stage costs)
so stage cost = difference of consecutive prefixes.

Run: python scripts/profile_e2e.py [N_ITERS] from the repository root
(one process per card: a JAX process reserves most of its memory)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n_iters = int(sys.argv[1]) if len(sys.argv) > 1 else 20

    import jax
    import jax.numpy as jnp

    from pgrtk.ops import query_e2e
    from pgrtk.ops.chain import chain_scores_fast
    from pgrtk.ops.pairs import (
        _rank_extract_planes,
        min_span_filter_gapped,
        pair_mers_gapped,
    )
    from pgrtk.ops.probe import probe_keys_aligned
    from pgrtk.ops.sketch import sketch_compact_mode2
    from pgrtk.utils import synth

    # ---- bench corpus (mirror of bench.py) ----
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
    QCHUNK = 16
    queries = np.stack([mutate(prng) for _ in range(B)]).reshape(
        B * QCHUNK, L // QCHUNK
    )
    BQ, LQ = queries.shape
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
    q_arr = jnp.asarray(queries)
    q_lens = jnp.full((BQ,), LQ, dtype=jnp.int32)

    M, SLOTS2, SLOTS3, LOOKBACK, UNROLL = 3, 192, 352, 24, 16
    SK = (12, 512, 192)
    PP = 32  # postings slots per key (row layout)

    def fold_planes(*arrs):
        acc = jnp.uint32(0)
        for a in arrs:
            if a.dtype == jnp.bool_:
                acc = acc + a.sum().astype(jnp.uint32)
            elif a.dtype == jnp.float32:
                acc = acc + (
                    jax.lax.bitcast_convert_type(a.sum(), jnp.uint32)
                    & jnp.uint32(7)
                )
            else:
                acc = acc + (a.astype(jnp.uint32).sum() & jnp.uint32(0xFFFF))
        return acc

    # ---- cumulative prefixes ----
    def upto_sketch(seqs, *_t):
        xh, xl, yl, valid, ovf = sketch_compact_mode2(
            seqs, q_lens, 56, 4, 64, 512, *SK
        )
        keep = min_span_filter_gapped(xh, xl, yl, valid, 64)
        pr = pair_mers_gapped(xh, xl, yl, keep, tie_orientation_one=True)
        return fold_planes(*[pr[k] for k in (
            "k0_hi", "k0_lo", "k1_hi", "k1_lo", "bgn", "end",
            "orientation", "pair_valid",
        )]) + ovf.astype(jnp.uint32)

    def _front(seqs):
        xh, xl, yl, valid, ovf = sketch_compact_mode2(
            seqs, q_lens, 56, 4, 64, 512, *SK
        )
        keep = min_span_filter_gapped(xh, xl, yl, valid, 64)
        pr = pair_mers_gapped(xh, xl, yl, keep, tie_orientation_one=True)
        planes = (
            pr["k0_hi"], pr["k0_lo"], pr["k1_hi"], pr["k1_lo"],
            pr["bgn"], pr["end"], pr["orientation"],
        )
        cp, cvalid, ovf2 = _rank_extract_planes(
            planes, pr["pair_valid"], pr["k0_hi"].shape[1], SLOTS2
        )
        return cp, cvalid, ovf | ovf2

    def upto_extract(seqs, *_t):
        cp, cvalid, ovf = _front(seqs)
        return fold_planes(*cp, cvalid) + ovf.astype(jnp.uint32)

    def upto_dup(seqs, *_t):
        cp, cvalid, ovf = _front(seqs)
        rl = query_e2e.dup_pair_counts(
            (cp[0], cp[1], cp[2], cp[3]), cvalid
        )
        return fold_planes(*cp, cvalid, rl) + ovf.astype(jnp.uint32)

    def upto_probe(seqs, p0, p1, p2, p3, fence, *_t):
        cp, cvalid, ovf = _front(seqs)
        rl = query_e2e.dup_pair_counts((cp[0], cp[1], cp[2], cp[3]), cvalid)
        table = dict(bits=bits, planes=[p0, p1, p2, p3], fence=fence)
        found, row = probe_keys_aligned(
            table, cp[0].reshape(-1), cp[1].reshape(-1),
            cp[2].reshape(-1), cp[3].reshape(-1),
        )
        return fold_planes(*cp, cvalid, rl, found, row) + ovf.astype(
            jnp.uint32
        )

    def upto_gather(seqs, p0, p1, p2, p3, fence, prows):
        cp, cvalid, ovf = _front(seqs)
        rl = query_e2e.dup_pair_counts((cp[0], cp[1], cp[2], cp[3]), cvalid)
        table = dict(bits=bits, planes=[p0, p1, p2, p3], fence=fence)
        found, row = probe_keys_aligned(
            table, cp[0].reshape(-1), cp[1].reshape(-1),
            cp[2].reshape(-1), cp[3].reshape(-1),
        )
        n_keys = prows.shape[0] - 1
        row_safe = jnp.where(found, row, n_keys)
        Pc = cp[0].shape[1]
        rows = jnp.take(prows, row_safe, axis=0).reshape(
            BQ, Pc, prows.shape[1]
        )
        return fold_planes(*cp, cvalid, rl, rows) + ovf.astype(jnp.uint32)

    def _through_expand(seqs, p0, p1, p2, p3, fence, prows):
        cp, cvalid, ovf = _front(seqs)
        rl = query_e2e.dup_pair_counts((cp[0], cp[1], cp[2], cp[3]), cvalid)
        table = dict(bits=bits, planes=[p0, p1, p2, p3], fence=fence)
        found, row = probe_keys_aligned(
            table, cp[0].reshape(-1), cp[1].reshape(-1),
            cp[2].reshape(-1), cp[3].reshape(-1),
        )
        n_keys = prows.shape[0] - 1
        row_safe = jnp.where(found, row, n_keys)
        Pc = cp[0].shape[1]
        rows = jnp.take(prows, row_safe, axis=0).reshape(
            BQ, Pc, prows.shape[1]
        )
        mr = rows[:, :, :PP]
        br = rows[:, :, PP:2 * PP]
        er = rows[:, :, 2 * PP:3 * PP]
        count_ok = rl <= 128
        base_hit = cvalid & found.reshape(BQ, Pc) & count_ok
        ex = query_e2e.expand_postings(mr, br, er, base_hit, rl, C, M, 128)
        return cp, cvalid, ovf, ex, Pc

    def upto_expand(seqs, *t):
        cp, cvalid, ovf, ex, _pc = _through_expand(seqs, *t)
        return fold_planes(
            ex["t_bgnori"], ex["t_end"], ex["hv"], ex["row_ovf"],
            ex["grp_ovf"],
        ) + ovf.astype(jnp.uint32)

    def _lanes(cp, ex, Pc):
        q_bgn, q_end, q_ori = cp[4], cp[5], cp[6]
        N = Pc * M

        def lane(v):
            return v.reshape(BQ * C, N)

        def lane_q(v):
            return jnp.broadcast_to(
                v[:, None, :, None], (BQ, C, Pc, M)
            ).reshape(BQ * C, N)

        qbo = q_bgn | (q_ori << 31)
        planes4 = (
            lane_q(qbo), lane_q(q_end),
            lane(ex["t_bgnori"]), lane(ex["t_end"]),
        )
        return planes4, lane(ex["hv"]), N

    MASK31 = jnp.uint32(0x7FFFFFFF)

    def _unpack(p4):
        return jnp.stack(
            [p4[0] & MASK31, p4[1], p4[0] >> 31,
             p4[2] & MASK31, p4[3], p4[2] >> 31],
            axis=-1,
        )

    def upto_lane_extract(seqs, *t):
        cp, cvalid, ovf, ex, Pc = _through_expand(seqs, *t)
        planes4, gvalid, N = _lanes(cp, ex, Pc)
        p4c, gv, _o = _rank_extract_planes(planes4, gvalid, N, SLOTS3)
        return fold_planes(*p4c, gv) + ovf.astype(jnp.uint32)

    def full(seqs, *t):
        cp, cvalid, ovf, ex, Pc = _through_expand(seqs, *t)
        planes4, gvalid, N = _lanes(cp, ex, Pc)
        p4c, gv, _o = _rank_extract_planes(planes4, gvalid, N, SLOTS3)
        anchors = _unpack(p4c)
        scores, prev, dup, inexact = chain_scores_fast(
            anchors, gv, 0.025, -1, False,
            lookback=LOOKBACK, max_span=8, unroll=UNROLL,
        )
        return fold_planes(scores, prev, dup, inexact, gv) + ovf.astype(
            jnp.uint32
        )

    def full_nocompact(seqs, *t):
        cp, cvalid, ovf, ex, Pc = _through_expand(seqs, *t)
        planes4, gvalid, N = _lanes(cp, ex, Pc)
        anchors = _unpack(planes4)
        scores, prev, dup, inexact = chain_scores_fast(
            anchors, gvalid, 0.025, -1, False,
            lookback=LOOKBACK, max_span=8, unroll=UNROLL,
        )
        return fold_planes(scores, prev, dup, inexact, gvalid) + ovf.astype(
            jnp.uint32
        )

    stages = [
        ("sketch+pairs", upto_sketch),
        ("+pair_extract", upto_extract),
        ("+dup_counts", upto_dup),
        ("+probe", upto_probe),
        ("+postings_gather", upto_gather),
        ("+expand", upto_expand),
        ("+lane_extract", upto_lane_extract),
        ("full(slots3)", full),
        ("full(no_compact)", full_nocompact),
    ]

    def timed(once):
        @jax.jit
        def chain_fn(seqs, n, *tbl):
            def body(_, carry):
                s, acc = carry
                a = once(s, *tbl)
                nxt = jnp.roll(s, (a & jnp.uint32(3)).astype(jnp.int32), axis=0)
                return (nxt, acc + a)

            return jax.lax.fori_loop(
                jnp.int32(0), n, body, (seqs, jnp.uint32(0))
            )

        int(chain_fn(q_arr, jnp.int32(1), *tables)[1])
        int(chain_fn(q_arr, jnp.int32(1), *tables)[1])
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            int(chain_fn(q_arr, jnp.int32(n_iters), *tables)[1])
            best = min(best, (time.time() - t0) / n_iters)
        return best

    total_bases = BQ * LQ
    prev_ms = 0.0
    for name, fn in stages:
        dt = timed(fn)
        ms = dt * 1e3
        print(
            f"{name:20s} {ms:8.2f} ms  (+{ms - prev_ms:7.2f})  "
            f"{total_bases / dt / 1e6:8.1f} Mb/s",
            flush=True,
        )
        if not name.startswith("full"):
            prev_ms = ms


if __name__ == "__main__":
    main()
