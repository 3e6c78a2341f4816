"""Randomized-corpus parity sweep of the v2 distributed e2e query.

Each seed builds a fresh adversarial mini-pangenome — random tandem
block with 2-5 copies, random N runs, ragged per-device lengths,
5e-4 SNPs — routes it through the v2 build + e2e query on the virtual
8-device mesh FOLLOWING THE FLAG CONTRACT (compact_overflow ->
SAFE_COMPACT_KW rerun; probe_overflow -> smaller lambda), and asserts
exact per-(query, target) anchor parity against the host reference
pipeline.  Seed 23 exercises the safe-compaction fallback live.

Run from the repository root:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python scripts/sweep_v2_parity.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from pgrtk.core import query as query_mod
from pgrtk.core.spec import ShmmrSpec
from pgrtk.ops import query_e2e
from pgrtk.parallel import mesh as pmesh

mesh = pmesh.make_mesh(8)
axis = mesh.axis_names[0]
spec = ShmmrSpec(80, 56, 4, 64, True)
BASES = b"ACGT"
for seed in (11, 23, 47):
    rng = np.random.default_rng(seed)
    B, L = 8, 131072
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    u = rng.integers(600, 4000)
    copies = int(rng.integers(2, 6))
    blk = rng.integers(0, 4, u, dtype=np.uint8)
    tot = L + u * copies
    seqs = np.zeros((B, tot + (512 - tot % 512) % 512), np.uint8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        s = base.copy()
        nm = rng.binomial(L, 5e-4)
        pos = rng.choice(L, nm, replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, nm)) % 4
        ins = np.concatenate([s[:50000]] + [blk]*copies + [s[50000:]])
        for _ in range(int(rng.integers(0, 4))):
            p0 = int(rng.integers(0, len(ins) - 200))
            ins[p0:p0 + int(rng.integers(5, 150))] = 5
        cut = int(rng.integers(0, 2048))
        lens[b] = len(ins) - cut
        seqs[b, :lens[b]] = ins[:lens[b]]
    rids = np.arange(B, dtype=np.uint32)
    sh = NamedSharding(mesh, P(axis, None)); sh1 = NamedSharding(mesh, P(axis))
    sd = jax.device_put(jnp.asarray(seqs), sh)
    ld = jax.device_put(jnp.asarray(lens), sh1)
    rd = jax.device_put(jnp.asarray(rids), sh1)
    from pgrtk.ops import pairs as pairs_ops
    ckw = None
    for lam in (64, 32, 16):
        v2 = pmesh.sharded_index_v2_step(
            mesh, 65536, chunk=512, avg_per_bucket=lam, compact_kw=ckw
        )(sd, ld, rd)
        if bool(v2["compact_overflow"]) and ckw is None:
            # flag contract: dense repeat cluster -> exact-walk rerun
            ckw = pairs_ops.SAFE_COMPACT_KW
            v2 = pmesh.sharded_index_v2_step(
                mesh, 65536, chunk=512, avg_per_bucket=lam, compact_kw=ckw
            )(sd, ld, rd)
        if not bool(v2["probe_overflow"]):
            break
    assert not bool(v2["compact_overflow"]) and not bool(v2["route_overflow"])
    e2e = pmesh.sharded_query_v2_e2e_step(
        mesh, 65536, n_targets=B, slots2=384, M=8, postings_cap=64,
        avg_per_bucket=lam, compact_kw=ckw,
    )(sd, ld, rd, *v2["probe"]["planes"])
    for f in ("compact_overflow", "route_overflow", "postings_overflow"):
        assert not bool(e2e[f]), (seed, f)
    anchors = np.asarray(e2e["anchors"]); gvalid = np.asarray(e2e["gvalid"])
    idx = query_e2e.build_index(seqs, target_lens=lens, n_decoys=0)
    lookup = idx["lookup"]
    n_anchors = 0
    for b in range(B):
        qb = bytes(bytearray(BASES[v] if v < 4 else 78 for v in seqs[b, :lens[b]]))
        raw = query_mod.raw_query_fragment(lambda s0, s1: lookup.get((s0, s1), []), qb, spec)
        th = query_mod.collect_target_hits(raw)
        for c in range(B):
            g = b * B + c
            dev = [tuple(int(v) for v in row) for row in anchors[g][gvalid[g]]]
            host = [(*l, *t) for l, t in th.get(c, [])]
            assert dev == host, (seed, b, c, len(dev), len(host))
            n_anchors += len(host)
    print(f"seed {seed}: lam={lam} copies={copies} anchors={n_anchors} parity OK", flush=True)
print("sweep OK")
