"""Benchmark: SHIMMER index + query throughput on one GPU.

Two timed device pipelines over a repeat-seeded synthetic pangenome
(B x L bases), each as N chained data-dependent iterations inside one
jit, synced once per timing window by a 4-byte scalar download:

  index: batched mode-2 SHIMMER sketch (two-level scan register walk +
         Wang hashing) -> sort-free compaction -> min_span filter ->
         canonical pair construction -> sorted pair table
  query: batched sketch -> compaction -> min_span -> canonical pairs ->
         in-query duplicate-pair count filter -> bucketed probe of every
         pair against a >=4M-key index table (ops/probe.py) -> general
         CSR postings-row expansion (arbitrary per-(key, sid)
         multiplicity, sid as data) -> per-(pair, sid) target count
         filter -> batched anchor-chain DP (ops/chain.py fast scan
         kernel) — the full query path of the reference's
         aln.rs:147-242, not just probe membership

The corpus is NOT best-case: every haplotype shares a 3-copy tandem
duplication and a 2-copy segmental duplication (so the postings carry
real per-(key, sid) multiplicity and the chain lanes see same-left
anchor runs), and the queries carry a 16-copy CNV tandem present in only
one target, whose postings hit-count (run_len x mult >= 225) exceeds the
reference's max_count=128 — the per-(pair, sid) count filter FIRES
inside the timed loop, certified by the stats pass before timing.
Index-stage content = the target haplotypes themselves (duplicate keys
in the final sort, not uniform-random keys).

Headline metric (driver BASELINE.json: "Mseq-bases/s SHIMMER index+query
per chip"): total bases pushed through BOTH stages / total time.
Baseline: the reference pgr-mdb builds the HPRC year-1 index (~300 Gbp)
in 30-40 min on a CPU server (reference: pgr-tk/src/lib.rs:40-42) —
~143 Mbases/s for the INDEX stage alone; its query stage is not faster
per base, so vs_baseline = ours_combined / 143e6 is conservative.

Runs in one process and fails when JAX finds no GPU.  Prints ONE JSON
line: {"metric", "value", "unit", "vs_baseline", ..., "platform",
"device_kind", "device_count", "gpu_name", "power_limit",
"peak_bytes_in_use"}.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_BASES_PER_S = 143e6
N_INDEX_KEYS = 4_194_304  # >=4M-key probe table for the query stage
CHUNK = 512
# level-2 sketch compaction widened 144 -> 192: the CNV tandem block
# sustains ~4-6 raw mers per 512-base chunk over its whole length,
# which overflows the default sizing (tuned for typical density);
# certified overflow-free before timing
SK_KW = dict(slots=12, block2=512, slots2=192)
# knobs of the fused query step, chosen by sweeps on the earlier
# accelerator (scripts/profile_e2e.py, sweep_e2e.py) and not yet
# re-decided on the H100:
#  * pair_block=None + slots2=192: one-block pair extract -> Pc=192; the
#    margin over the corpus's max pairs per 64 kb row is guarded by the
#    overflow flag + untimed certify, which fail LOUDLY if pairs grow
#  * P=32 postings in ONE 128-wide aligned row per key
#  * M=3 (max surviving multiplicity is the 3-copy tandem),
#    lookback=24 (>= M*max_span distinct-left window; certified)
#  * no slots3 lane compaction
E2E_KW = dict(
    slots2=192, lookback=24, unroll=16, M=3, P=32,
    sketch_compact=(12, 512, 192), pair_block=None,
)


def bench_corpus(B=8, L=1_048_576, qchunk=16, n_index_keys=N_INDEX_KEYS,
                 build_lookup=False):
    """The benchmark's repeat-seeded pangenome: B targets of L bases and
    B query haplotypes cut into B*qchunk ROI rows, with the index built
    over the targets plus decoy keys up to `n_index_keys`.

    One base haplotype with a realistic repeat structure, embedded at
    fixed query-chunk offsets so each repeat block sits strictly inside
    one query chunk (the defaults give 64 kb chunks):
      * tandem16: a 3 kb unit x16 (48 kb CNV block) — present in the
        base (hence every query) and in target 0 ONLY (targets 1.. carry
        random filler there, a structural variant).  Its pair keys have
        per-(key, sid=0) multiplicity 15-16 and in-query run length
        15-16, so run_len*mult >= 225 > max_count=128 and the
        reference's per-(pair, sid) count filter fires (aln.rs:213-221).
        SNPs are excluded from this block so the firing is
        deterministic.
      * tandem3: an 8 kb unit x3, shared by all haplotypes —
        multiplicity-3 postings that PASS the filters and chain as
        same-left anchor runs (3 x 8 targets = 24 postings <= P=32).
      * segdup: a 24 kb block at two loci, shared — multiplicity 2.
    Raises RuntimeError when the corpus lacks the properties the timed
    number depends on."""
    from pgrtk.ops import query_e2e
    from pgrtk.utils import synth

    qcb = L // qchunk
    S16, U16, N16 = (3 * qchunk // 16) * qcb + 8_192, 3_072, 16
    E16 = S16 + U16 * N16
    S3, U3, N3 = (7 * qchunk // 16) * qcb + 16_384, 8_192, 3
    SD1 = (9 * qchunk // 16) * qcb + 4_096
    SD2 = (13 * qchunk // 16) * qcb + 4_096
    SDL = 24_576

    prng = np.random.default_rng(2)
    base = prng.integers(0, 4, size=L, dtype=np.uint8)
    # a random unit's perfect tandem is often INVISIBLE to the sketch
    # (equal-adjacent-hash mers die to the distinctness rule,
    # shmmrutils.rs:545-548) — pick units verified to survive
    base[S16:E16] = np.tile(synth.pick_tandem_unit(prng, U16, N16), N16)
    base[S3:S3 + U3 * N3] = np.tile(synth.pick_tandem_unit(prng, U3, N3), N3)
    sd = prng.integers(0, 4, SDL, dtype=np.uint8)
    base[SD1:SD1 + SDL] = sd
    base[SD2:SD2 + SDL] = sd

    def mutate(rng, drop16: bool = False):
        out = base.copy()
        if drop16:  # structural variant: replace the CNV block
            out[S16:E16] = rng.integers(0, 4, E16 - S16, dtype=np.uint8)
        n = rng.binomial(L, 1e-4)
        pos = rng.choice(L, size=n, replace=False)
        pos = pos[(pos < S16) | (pos >= E16)]  # deterministic CNV block
        out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
        return out

    targets = np.stack([mutate(prng, drop16=(sid != 0)) for sid in range(B)])
    queries = np.stack([mutate(prng) for _ in range(B)]).reshape(
        B * qchunk, qcb
    )
    idx = query_e2e.build_index(
        targets, n_decoys=n_index_keys, build_lookup=build_lookup, P=32
    )
    if idx["n_multi"] == 0:
        raise RuntimeError("repeat corpus produced no multiplicity")
    if idx["n_truncated"] != 0:
        raise RuntimeError("corpus overflows the postings rows")
    # the CNV tandem's keys must be visible at (near-)full multiplicity,
    # so its postings hit-counts exceed max_count=128 in matching queries
    if idx["max_mult"] < N16 - 2:
        raise RuntimeError(f"CNV multiplicity {idx['max_mult']} < {N16 - 2}")
    return dict(targets=targets, queries=queries, idx=idx, C=B)


def index_stage(seqs_u8, lens):
    """The timed index stage: sketch -> compaction -> min_span -> pairs
    -> sorted pair table.  Returns (table, overflow)."""
    import jax.numpy as jnp

    from pgrtk.ops import pairs as pairs_ops
    from pgrtk.ops import sketch as sketch_ops

    xh, xl, yl, valid, ovf = sketch_ops.sketch_compact_mode2(
        seqs_u8, lens, 56, 4, 64, CHUNK, **SK_KW
    )
    keep = pairs_ops.min_span_filter_gapped(xh, xl, yl, valid, 64)
    pr = pairs_ops.pair_mers_gapped(xh, xl, yl, keep)
    rids = jnp.arange(seqs_u8.shape[0], dtype=jnp.uint32)
    return pairs_ops.sort_pairs(pr, rids), ovf


def query_tables(corpus):
    """Device arguments of the query step: 4 probe planes, the fence
    rows and the postings rows.  Big tables go in as jit ARGUMENTS, not
    captured constants."""
    import jax.numpy as jnp

    idx = corpus["idx"]
    probe = idx["probe"]
    return tuple(jnp.asarray(probe["planes"][i]) for i in range(4)) + (
        jnp.asarray(probe["fence_rows"]), jnp.asarray(idx["p_rows"]),
    )


def query_step(corpus):
    """fn(seqs_u8, p0, p1, p2, p3, fence, prows) -> query_e2e_step result
    at the bench's operating point (traceable; callers jit it)."""
    import jax.numpy as jnp

    from pgrtk.ops import query_e2e

    probe = corpus["idx"]["probe"]
    bits, C = probe["bits"], corpus["C"]
    BQ, LQ = corpus["queries"].shape
    q_lens = jnp.full((BQ,), LQ, dtype=jnp.int32)

    def step(seqs_u8, p0, p1, p2, p3, fence, prows):
        return query_e2e.query_e2e_step(
            seqs_u8, q_lens, bits, [p0, p1, p2, p3], fence, prows, C,
            probe_aligned=probe.get("aligned", False), **E2E_KW,
        )

    return step


def e2e_flags(res) -> dict:
    """Host counts of a query step's flags and filters."""
    return dict(
        overflow=int(res["overflow"]),
        dup_groups=int(np.asarray(res["dup"]).sum()),
        inexact_groups=int(np.asarray(res["inexact"]).sum()),
        row_ovf=int(np.asarray(res["row_ovf"]).sum()),
        mult_ovf=int(np.asarray(res["mult_ovf"]).sum()),
        lane_ovf=int(np.asarray(res["lane_ovf"]).sum()),
        n_anchors=int(np.asarray(res["gvalid"]).sum()),
        n_q_filtered=int(res["n_q_filtered"]),
        n_t_filtered=int(res["n_t_filtered"]),
    )


def check_e2e_flags(f: dict) -> None:
    """A dirty flag means dropped anchors or an inexact chain window, and
    a throughput number would be meaningless; the CNV tandem must make
    the per-(pair, sid) count filter FIRE."""
    dirty = {k: f[k] for k in ("overflow", "dup_groups", "inexact_groups",
                               "row_ovf", "mult_ovf", "lane_ovf") if f[k]}
    if dirty:
        raise RuntimeError(f"e2e query flags dirty: {dirty}")
    if f["n_t_filtered"] <= 0:
        raise RuntimeError("target count filter never fired: corpus too clean")


def main():
    from pgrtk.utils import gpu

    devs = gpu.require_gpu("bench")
    import jax
    import jax.numpy as jnp

    from pgrtk.ops import query_e2e

    cards = gpu.card_info()
    corpus = bench_corpus()
    idx = corpus["idx"]
    arr = jnp.asarray(corpus["targets"])  # index stage on real content
    B, L = corpus["targets"].shape
    lens = jnp.full((B,), L, dtype=jnp.int32)

    def index_once(seqs_u8):
        table, ovf = index_stage(seqs_u8, lens)
        # fold the table into a scalar so iterations chain (data
        # dependency prevents overlap across timed iterations)
        return (
            table["valid"].sum().astype(jnp.uint32)
            + (table["k0_lo"].sum() & jnp.uint32(3))
            + ovf.astype(jnp.uint32)
        )

    # certify both stages BEFORE timing: a set flag would mean silently
    # dropped mers or anchors
    _table, ovf_idx = jax.jit(index_stage)(arr, lens)
    if bool(ovf_idx):
        raise RuntimeError("index sketch compaction overflowed")
    q_tables = query_tables(corpus)
    q_arr = jnp.asarray(corpus["queries"])
    step = query_step(corpus)
    flags = e2e_flags(jax.jit(step)(q_arr, *q_tables))
    check_e2e_flags(flags)

    def query_once(seqs_u8, *tables):
        return query_e2e.fold_e2e_scalar(step(seqs_u8, *tables))

    def timed_chain(once, seqs, *tables, perturb="content"):
        @jax.jit
        def chain(seqs_u8, n, *tbl):
            def body(_, carry):
                s, acc = carry
                a = once(s, *tbl)
                pert = a & jnp.uint32(3)
                if perturb == "content":
                    nxt = (s + pert.astype(jnp.uint8)) % jnp.uint8(4)
                else:  # roll rows: content-preserving data dependency
                    nxt = jnp.roll(s, pert.astype(jnp.int32), axis=0)
                return (nxt, acc + a)

            return jax.lax.fori_loop(
                jnp.int32(0), n, body, (seqs_u8, jnp.uint32(0))
            )

        # n passed as a device scalar: ONE compile serves warm-up and the
        # timed runs
        int(chain(seqs, jnp.int32(1), *tables)[1])  # warm-up / compile
        int(chain(seqs, jnp.int32(1), *tables)[1])  # settle dispatch path
        # best of 3 identical timing windows; the 4-byte download at the
        # end of each window waits for the device
        N, WINDOWS = 50, 3
        dt = float("inf")
        for _ in range(WINDOWS):
            t0 = time.time()
            int(chain(seqs, jnp.int32(N), *tables)[1])
            dt = min(dt, (time.time() - t0) / N)
        return B * L / dt

    idx_mbs = timed_chain(index_once, arr) / 1e6
    qry_mbs = timed_chain(query_once, q_arr, *q_tables, perturb="roll") / 1e6
    combined = 2.0 / (1.0 / idx_mbs + 1.0 / qry_mbs)
    name, power = cards[0]
    rec = {
        "metric": "shimmer_index_query_throughput",
        "unit": "Mbases/s/chip",
        "value": combined,
        "vs_baseline": combined * 1e6 / BASELINE_BASES_PER_S,
        "index_mbases_s": idx_mbs,
        "query_mbases_s": qry_mbs,
        "query_index_keys": N_INDEX_KEYS,
        "n_multi": idx["n_multi"],
        "n_truncated": idx["n_truncated"],
        "max_postings": idx["max_postings"],
        "n_anchors": flags["n_anchors"],
        "n_q_filtered": flags["n_q_filtered"],
        "n_t_filtered": flags["n_t_filtered"],
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "gpu_name": name,
        "power_limit": power,
        "peak_bytes_in_use": gpu.peak_bytes_in_use(devs[0]),
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
