"""Device mesh construction and sharded pipeline steps.

The reference is single-node rayon data parallelism (SURVEY §2.3); the
scale-out axis here is the same one — sequences/queries — sharded over a
1-D ("data",) jax.sharding.Mesh.  The SHIMMER index is replicated per
device in v1 (HPRC-year-1 scale fits device memory; matches reference
mmap semantics); cross-device reductions are collectives:
  - psum for pair/coverage counts
  - all_gather for merged hit lists
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import pairs as pairs_ops
from ..ops import sketch as sketch_ops

U32 = jnp.uint32


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))



def _sketch_compact(seqs_u8, lengths, rids, k, r, min_span, chunk,
                    compact_kw):
    """Shared sketch+compaction front end for every sharded step: the
    scan-fused path by default, or the exact two-level walk + explicit
    compaction sizing (pairs_ops.SAFE_COMPACT_KW) for the overflow-gated
    safe rerun.  The returned flag covers compaction overflow AND the
    overlap-walk inexact condition — steps must surface it so callers
    can rerun with compact_kw set."""
    if compact_kw is None:
        return sketch_ops.sketch_compact_mode2(
            seqs_u8, lengths, k, r, min_span, chunk
        )
    out = sketch_ops.sketch_mode2_dense(
        seqs_u8, lengths, rids, k, r, min_span, chunk, exact=True
    )
    return pairs_ops.compact_mers_packed(
        out["x_hi"], out["x_lo"], out["y_lo"], out["selected"],
        **compact_kw
    )


def sharded_sketch_index_step(
    mesh: Mesh,
    k: int = 56,
    r: int = 4,
    min_span: int = 64,
    chunk: int = 512,
    compact_kw: Optional[dict] = None,
):
    """Build the jitted multi-chip indexing step.

    The returned fn maps (seqs_u8 (B, L), lengths (B,), rids (B,)) — B
    sharded over the data axis — to a dict with the locally-sorted pair
    table (sharded) and globally psum-reduced statistics.  This is the
    flagship "one training step equivalent": sketch -> compact ->
    min_span filter -> pair -> sort -> global stats, all on device.
    """
    from jax import shard_map

    axis = mesh.axis_names[0]

    def local_step(seqs_u8, lengths, rids):
        xh, xl, yl, valid, ovf = _sketch_compact(
            seqs_u8, lengths, rids, k, r, min_span, chunk, compact_kw
        )
        keep = pairs_ops.min_span_filter_gapped(xh, xl, yl, valid, min_span)
        # pair consecutive KEPT mers directly (jump-pointer next-kept
        # propagation) — the whole path to the key sort is sort-free
        pr = pairs_ops.pair_mers_gapped(xh, xl, yl, keep)
        n_pairs_local = pr["pair_valid"].sum()
        n_mers_local = keep.sum()
        n_pairs = jax.lax.psum(n_pairs_local, axis)
        n_mers = jax.lax.psum(n_mers_local, axis)
        # any-shard overflow: callers rerun the step built with
        # compact_kw=pairs_ops.SAFE_COMPACT_KW, then the exact host path
        # (block-local slot loss is not silent)
        overflow = jax.lax.psum(ovf.astype(jnp.int32), axis) > 0
        # replicated-index v1: gather every shard's pairs (PACKED: 7
        # planes instead of 9 — 22% less collective traffic) and stable-sort
        # the merged table ONCE on each device.  No local pre-sort: the
        # gathered flat order is (sid, position)-ordered (ascending rids
        # per shard, shards in axis order), which the stable sort
        # preserves for equal keys — reference postings order for free.
        packed = pairs_ops.pack_pair_planes(pr, rids)
        gathered = {
            kk: jax.lax.all_gather(v, axis, tiled=True)
            for kk, v in packed.items()
        }
        table = pairs_ops.unpack_pair_table(
            pairs_ops.sort_packed_planes(gathered)
        )
        return dict(table=table, n_pairs=n_pairs, n_mers=n_mers,
                    overflow=overflow)

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=dict(
            table={
                kk: P()
                for kk in (
                    "valid", "k0_hi", "k0_lo", "k1_hi", "k1_lo", "sid",
                    "bgn", "end", "orientation",
                )
            },
            n_pairs=P(),
            n_mers=P(),
            overflow=P(),
        ),
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_sketch_index_step_auto(
    mesh: Mesh,
    k: int = 56,
    r: int = 4,
    min_span: int = 64,
    chunk: int = 512,
):
    """Overflow-safe driver around sharded_sketch_index_step: runs the
    fast fused step, and when its overflow flag fires (a dense repeat
    cluster beyond the aggressive compaction sizing, or a
    boundary-straddling N-run) reruns the same batch through the exact
    two-level walk + SAFE_COMPACT_KW sizing.  The safe step compiles
    lazily (first overflow) and is reused.  Raises OverflowError if even
    the safe sizing overflows — callers then build via the exact host
    path."""
    fast = sharded_sketch_index_step(mesh, k, r, min_span, chunk)
    safe_step = []

    def run(seqs_u8, lengths, rids):
        out = fast(seqs_u8, lengths, rids)
        if not bool(out["overflow"]):
            return out
        if not safe_step:
            safe_step.append(
                sharded_sketch_index_step(
                    mesh, k, r, min_span, chunk,
                    compact_kw=pairs_ops.SAFE_COMPACT_KW,
                )
            )
        out = safe_step[0](seqs_u8, lengths, rids)
        if bool(out["overflow"]):
            raise OverflowError(
                "compaction overflow at SAFE_COMPACT_KW sizing; "
                "rebuild this batch via the exact host path"
            )
        return out

    return run


def sharded_query_count_step(mesh: Mesh, k: int = 56, r: int = 4,
                             min_span: int = 64, chunk: int = 512,
                             compact_kw: Optional[dict] = None):
    """Multi-chip query step: sketch the (sharded) query batch against a
    replicated sorted key table; per-shard hit counts are merged with
    psum and the per-query hit mask all_gathered.  Returns (n_hits,
    all_hits, overflow); on overflow rerun a step built with
    compact_kw=pairs_ops.SAFE_COMPACT_KW."""
    from jax import shard_map

    axis = mesh.axis_names[0]

    def local_step(seqs_u8, lengths, rids, key_hi0, key_lo0, key_hi1, key_lo1):
        xh, xl, yl, valid, _ovf = _sketch_compact(
            seqs_u8, lengths, rids, k, r, min_span, chunk, compact_kw
        )
        keep = pairs_ops.min_span_filter_gapped(xh, xl, yl, valid, min_span)
        pr = pairs_ops.pair_mers_gapped(xh, xl, yl, keep)
        # vectorized binary search of each pair key in the replicated table
        hit = _searchsorted_pairkey(
            key_hi0, key_lo0, key_hi1, key_lo1,
            pr["k0_hi"], pr["k0_lo"], pr["k1_hi"], pr["k1_lo"],
        )
        hit = hit & pr["pair_valid"]
        n_hits = jax.lax.psum(hit.sum(), axis)
        all_hits = jax.lax.all_gather(hit, axis, tiled=True)
        overflow = jax.lax.psum(_ovf.astype(jnp.int32), axis) > 0
        return n_hits, all_hits, overflow

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis), P(axis), P(), P(), P(), P(),
        ),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_query_probe_step(mesh: Mesh, bits: int, k: int = 56,
                             r: int = 4, min_span: int = 64,
                             chunk: int = 512,
                             compact_kw: Optional[dict] = None):
    """Multi-chip query step against a replicated bucketed PROBE table
    (ops/probe.py): one aligned row fetch + W-wide compare per pair key
    instead of a gather-bound binary search.

    The returned fn takes (seqs_u8, lengths, rids, p0, p1, p2, p3) with
    p* the (2^bits, W) probe planes (replicated).  Returns (n_hits,
    all_hits, overflow); on overflow rerun a step built with
    compact_kw=pairs_ops.SAFE_COMPACT_KW."""
    from jax import shard_map

    from ..ops import probe as probe_ops

    axis = mesh.axis_names[0]

    def local_step(seqs_u8, lengths, rids, p0, p1, p2, p3):
        xh, xl, yl, valid, _ovf = _sketch_compact(
            seqs_u8, lengths, rids, k, r, min_span, chunk, compact_kw
        )
        keep = pairs_ops.min_span_filter_gapped(xh, xl, yl, valid, min_span)
        pr = pairs_ops.pair_mers_gapped(xh, xl, yl, keep)
        B, C = pr["k0_hi"].shape
        table = dict(bits=bits, planes=[p0, p1, p2, p3], row=None)
        found = probe_ops.probe_found(
            table,
            pr["k0_hi"].reshape(-1), pr["k0_lo"].reshape(-1),
            pr["k1_hi"].reshape(-1), pr["k1_lo"].reshape(-1),
        )
        hit = found.reshape(B, C) & pr["pair_valid"]
        n_hits = jax.lax.psum(hit.sum(), axis)
        all_hits = jax.lax.all_gather(hit, axis, tiled=True)
        overflow = jax.lax.psum(_ovf.astype(jnp.int32), axis) > 0
        return n_hits, all_hits, overflow

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis), P(axis), P(), P(), P(), P(),
        ),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def _searchsorted_pairkey(t_h0, t_l0, t_h1, t_l1, q_h0, q_l0, q_h1, q_l1):
    """Does each query pair key exist in the sorted table?  128-bit keys as
    4 u32 planes; lexicographic binary search, fully vectorized."""
    # 128-bit lexicographic lower_bound by explicit binary search over the
    # 4 u32 planes (jnp.searchsorted only handles single-plane keys).
    n = t_h0.shape[0]
    n_steps = max(1, int(np.ceil(np.log2(n + 1))))

    def t_less_q(idx):
        th0, tl0 = t_h0[idx], t_l0[idx]
        th1, tl1 = t_h1[idx], t_l1[idx]
        return (
            (th0 < q_h0)
            | ((th0 == q_h0) & (tl0 < q_l0))
            | ((th0 == q_h0) & (tl0 == q_l0) & (th1 < q_h1))
            | (
                (th0 == q_h0)
                & (tl0 == q_l0)
                & (th1 == q_h1)
                & (tl1 < q_l1)
            )
        )

    lo = jnp.zeros(q_h0.shape, dtype=jnp.int32)
    hi = jnp.full(q_h0.shape, n, dtype=jnp.int32)
    for _ in range(n_steps):
        active = lo < hi
        mid = jnp.clip((lo + hi) // 2, 0, n - 1)
        less = t_less_q(mid)
        lo = jnp.where(active & less, mid + 1, lo)
        hi = jnp.where(active & ~less, mid, hi)
    idx = jnp.clip(lo, 0, n - 1)
    found = (
        (lo < n)
        & (t_h0[idx] == q_h0)
        & (t_l0[idx] == q_l0)
        & (t_h1[idx] == q_h1)
        & (t_l1[idx] == q_l1)
    )
    return found


def probe_bits_for(shard_capacity: int, avg_per_bucket: int = 64) -> int:
    """Bucket-index width for a per-shard probe table (ops/probe.py
    geometry: ~avg_per_bucket keys per W=128-wide bucket row)."""
    return max(
        1, int(np.ceil(np.log2(max(2, shard_capacity / avg_per_bucket))))
    )


PROBE_W = 128  # probe bucket row width (slots per row)


def _shard_probe_planes(shard, bits: int):
    """Build the bucketed probe planes for ONE shard's pair table, on
    device (jit/shard_map-safe — the host build in ops/probe.py sizes W
    dynamically; here W is the static 128 and overflow is flagged).

    Buckets come from the TOP bits of hash0's LOW u32 plane (k0_lo),
    which are uniform and independent of the hash-range sharding (that
    uses the high plane), so bucket geometry is identical on every shard
    and for queries regardless of n_devices.

    Alongside the 4 key planes, the table's POSTINGS fields (sid,
    orientation<<31|bgn, end) are scattered into the same (bucket, col)
    geometry — a probe row fetch then doubles as postings expansion:
    every occurrence of a key sits in its bucket row, so the 128-wide
    hit mask marks the key's full postings list with no extra gather.

    Returns (planes[7] (2^bits, W) u32 — k0_hi, k0_lo, k1_hi, k1_lo,
    sid, bgnori, end —, row (2^bits, W) i32, probe_overflow bool).
    """
    nb = 1 << bits
    k0h, k0l = shard["k0_hi"], shard["k0_lo"]
    k1h, k1l = shard["k1_hi"], shard["k1_lo"]
    valid = shard["valid"]
    n = k0h.shape[0]
    bucket = (k0l >> (32 - bits)).astype(jnp.int32)
    bucket = jnp.where(valid, bucket, nb)  # invalid -> out of range
    # within-bucket column = rank among same-bucket entries: sort entry
    # ids by bucket, then col = position - bucket run start
    b_sorted, idx_sorted = jax.lax.sort(
        (bucket, jnp.arange(n, dtype=jnp.int32)), num_keys=1
    )
    starts = jnp.searchsorted(b_sorted, jnp.arange(nb, dtype=jnp.int32))
    col = jnp.arange(n, dtype=jnp.int32) - jnp.take(
        starts, jnp.clip(b_sorted, 0, nb - 1)
    )
    probe_overflow = ((col >= PROBE_W) & (b_sorted < nb)).any()
    # scatter each entry into its (bucket, col) slot; out-of-range
    # (invalid or overflowing) targets drop
    target = jnp.where(
        (b_sorted < nb) & (col < PROBE_W),
        b_sorted * PROBE_W + col,
        nb * PROBE_W,
    )
    bgnori = (shard["orientation"] << 31) | shard["bgn"]
    planes = []
    for plane, fill in (
        (k0h, U32(0xFFFFFFFF)), (k0l, U32(0xFFFFFFFF)),
        (k1h, U32(0xFFFFFFFF)), (k1l, U32(0xFFFFFFFF)),
        (shard["sid"], U32(0)), (bgnori, U32(0)), (shard["end"], U32(0)),
    ):
        flat = jnp.full((nb * PROBE_W,), fill)
        flat = flat.at[target].set(
            jnp.take(plane, idx_sorted), mode="drop"
        )
        planes.append(flat.reshape(nb, PROBE_W))
    rflat = jnp.full((nb * PROBE_W,), -1, dtype=jnp.int32)
    rflat = rflat.at[target].set(idx_sorted, mode="drop")
    return planes, rflat.reshape(nb, PROBE_W), probe_overflow


def sharded_index_v2_step(
    mesh: Mesh,
    shard_capacity: int,
    k: int = 56,
    r: int = 4,
    min_span: int = 64,
    chunk: int = 512,
    route_capacity: Optional[int] = None,
    compact_kw: Optional[dict] = None,
    avg_per_bucket: int = 64,
):
    """Memory-scalable index build (sharding v2):
    each device keeps only ITS hash range of the global pair table, and
    NO device ever materializes the full table — pairs are routed to
    their range owner with one all_to_all.

    Per device: sketch/pair/key-sort the LOCAL sequences, cut the sorted
    local table into n_devices contiguous hash-range runs (hash0's top
    bits are uniform Wang-hash bits, so runs are balanced; each run is
    one dynamic_slice — no gather), all_to_all the (n_dev, route_cap)
    buffers so every device receives exactly its range, then one local
    sort of the received ~2/n_dev-of-local-size buffer builds the shard
    table, and a bucketed probe table (ops/probe.py geometry) is built
    over it on device.  Peak memory is O(local + shard), not O(table).

    Returns dict(shard=<per-device table planes, sharded along axis>,
    probe=dict(planes, row) sharded likewise, n_pairs, shard_overflow,
    route_overflow, probe_overflow, compact_overflow).
    """
    from jax import shard_map

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    # avg_per_bucket sizes the per-shard probe buckets.  64 halves the
    # plane memory vs 32 but overflows when per-key multiplicity is
    # high (all postings of a key share ONE 128-slot bucket row: 16
    # near-identical haplotypes put 16-entry runs in each key's bucket
    # — observed overflowing 12/128 buckets at a 16-device dryrun).
    # probe_overflow reports it; callers retry with 32/16 (query steps
    # must be built with the SAME value).
    bits = probe_bits_for(shard_capacity, avg_per_bucket)

    def local_step(seqs_u8, lengths, rids):
        xh, xl, yl, valid, c_ovf = _sketch_compact(
            seqs_u8, lengths, rids, k, r, min_span, chunk, compact_kw
        )
        keep = pairs_ops.min_span_filter_gapped(xh, xl, yl, valid, min_span)
        pr = pairs_ops.pair_mers_gapped(xh, xl, yl, keep)
        # local key sort in the PACKED layout (7 planes, stable 4-key
        # sort) — validity rides the key words (invalid = all-ones),
        # so the route needs no separate valid plane: 7 all_to_all
        # stacks instead of 9
        local = pairs_ops.sort_packed_planes(
            pairs_ops.pack_pair_planes(pr, rids)
        )
        C = local["w0"].shape[0]
        route_cap = route_capacity or min(
            C, max(128, -(-2 * C // n_dev))
        )
        n_valid = ((local["w3"] & U32(1)) == 0).sum().astype(jnp.int32)

        # destination runs: hash0 in [d, d+1) * 2^56 / n_dev.  w0 holds
        # hash0 >> 24, so the k0_hi (hash0 >> 32) bound b becomes b<<8 —
        # the exact same partition (invalid slots are all-ones and sort
        # past every bound)
        # masked to u32: at n_dev=1 the bounds array below is EMPTY
        # (no interior range boundaries), so the wrapped value is
        # never read — without the mask a 1-device mesh failed to
        # trace (2^32 out of uint32 range)
        per = jnp.uint32((((1 << 24) // n_dev) << 8) & 0xFFFFFFFF)
        bounds = (jnp.arange(1, n_dev, dtype=jnp.uint32) * per)
        offs = jnp.searchsorted(local["w0"], bounds).astype(jnp.int32)
        off_full = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), offs, n_valid[None]]
        )
        cnt = off_full[1:] - off_full[:-1]
        route_overflow = (cnt > route_cap).any()

        fields = ("w0", "w1", "w2", "w3", "sid", "bgnori", "end")
        jrow = jnp.arange(route_cap, dtype=jnp.int32)
        send = {kk: [] for kk in fields}
        for d in range(n_dev):  # static: n_dev contiguous slices
            start = jnp.clip(off_full[d], 0, max(0, C - route_cap))
            gidx = start + jrow
            mask = (gidx >= off_full[d]) & (gidx < off_full[d + 1])
            for kk in fields:
                v = jax.lax.dynamic_slice(local[kk], (start,), (route_cap,))
                if kk in ("w0", "w1", "w2", "w3"):
                    v = jnp.where(mask, v, U32(0xFFFFFFFF))
                send[kk].append(v)
        buf = {kk: jnp.stack(send[kk]) for kk in fields}

        # one all_to_all: device d receives every range-d run
        recv = {
            kk: jax.lax.all_to_all(v, axis, 0, 0).reshape(-1)
            for kk, v in buf.items()
        }
        n_mine = ((recv["w3"] & U32(1)) == 0).sum()
        shard_overflow = jax.lax.psum(
            (n_mine > shard_capacity).astype(jnp.int32), axis
        ) > 0

        # stable local sort of the received buffer (all-ones keys sort
        # last; received flat order is source-device-major = ascending
        # sid, so equal keys keep reference postings order), padded/
        # truncated to the static shard_capacity
        rsize = n_dev * route_cap
        if rsize < shard_capacity:
            pad = shard_capacity - rsize
            for kk in ("w0", "w1", "w2", "w3"):
                recv[kk] = jnp.concatenate(
                    [recv[kk], jnp.full((pad,), U32(0xFFFFFFFF))]
                )
            for kk in ("sid", "bgnori", "end"):
                recv[kk] = jnp.concatenate(
                    [recv[kk], jnp.zeros((pad,), recv[kk].dtype)]
                )
        sorted_packed = pairs_ops.sort_packed_planes(recv)
        shard = pairs_ops.unpack_pair_table(
            {kk: v[:shard_capacity] for kk, v in sorted_packed.items()}
        )
        n_pairs = jax.lax.psum(shard["valid"].sum(), axis)
        planes, row, probe_overflow = _shard_probe_planes(shard, bits)
        probe_overflow = jax.lax.psum(
            probe_overflow.astype(jnp.int32), axis
        ) > 0
        return dict(
            shard=shard,
            probe=dict(planes=planes, row=row),
            n_pairs=n_pairs,
            shard_overflow=shard_overflow,
            compact_overflow=jax.lax.psum(
                c_ovf.astype(jnp.int32), axis
            ) > 0,
            route_overflow=jax.lax.psum(
                route_overflow.astype(jnp.int32), axis
            ) > 0,
            probe_overflow=probe_overflow,
        )

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=dict(
            shard={kk: P(axis) for kk in (
                "valid", "k0_hi", "k0_lo", "k1_hi", "k1_lo", "sid",
                "bgn", "end", "orientation",
            )},
            probe=dict(planes=[P(axis)] * 7, row=P(axis)),
            n_pairs=P(),
            shard_overflow=P(),
            compact_overflow=P(),
            route_overflow=P(),
            probe_overflow=P(),
        ),
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_query_v2_step(
    mesh: Mesh,
    shard_capacity: int,
    k: int = 56,
    r: int = 4,
    min_span: int = 64,
    chunk: int = 512,
    compact_kw: Optional[dict] = None,
    avg_per_bucket: int = 64,
):
    """Query fan-out against the hash-range-sharded v2 index: queries
    are sketched where they live, query KEYS are all_gathered (keys are
    tiny next to sequences), every device probes its own shard's
    bucketed probe planes (one aligned row fetch + 128-wide compare per
    key — the repo's measured ~20x win over the binary search), and
    per-device hit masks OR-combine with psum.

    Takes (seqs_u8, lengths, rids, p0, p1, p2, p3) with p* the per-shard
    probe planes from sharded_index_v2_step (sharded along the axis) and
    returns (n_hits, found mask over the gathered query pair slots,
    overflow); on overflow rerun a step built with
    compact_kw=pairs_ops.SAFE_COMPACT_KW.
    """
    from jax import shard_map

    axis = mesh.axis_names[0]
    bits = probe_bits_for(shard_capacity, avg_per_bucket)

    def local_step(seqs_u8, lengths, rids, p0, p1, p2, p3):
        xh, xl, yl, valid, _ovf = _sketch_compact(
            seqs_u8, lengths, rids, k, r, min_span, chunk, compact_kw
        )
        keep = pairs_ops.min_span_filter_gapped(xh, xl, yl, valid, min_span)
        pr = pairs_ops.pair_mers_gapped(xh, xl, yl, keep)

        def gq(v):
            return jax.lax.all_gather(v.reshape(-1), axis, tiled=True)

        q0h, q0l, q1h, q1l = (gq(pr[kk]) for kk in
                              ("k0_hi", "k0_lo", "k1_hi", "k1_lo"))
        q_valid = gq(pr["pair_valid"])
        # bucket geometry matches _shard_probe_planes: top `bits` of the
        # hash0 LOW plane, independent of the range sharding
        bucket = (q0l >> (32 - bits)).astype(jnp.int32)
        hit = (
            (jnp.take(p0, bucket, axis=0) == q0h[:, None])
            & (jnp.take(p1, bucket, axis=0) == q0l[:, None])
            & (jnp.take(p2, bucket, axis=0) == q1h[:, None])
            & (jnp.take(p3, bucket, axis=0) == q1l[:, None])
        ).any(axis=1)
        found = jax.lax.psum(
            (hit & q_valid).astype(jnp.int32), axis
        ) > 0
        n_hits = found.sum()
        overflow = jax.lax.psum(_ovf.astype(jnp.int32), axis) > 0
        return n_hits, found, overflow

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis), P(axis),
            P(axis), P(axis), P(axis), P(axis),
        ),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_query_v2_e2e_step(
    mesh: Mesh,
    shard_capacity: int,
    n_targets: int,
    k: int = 56,
    r: int = 4,
    min_span: int = 64,
    chunk: int = 512,
    slots2: int = 384,
    penalty: float = 0.025,
    lookback: int = 32,
    max_span: int = 8,
    M: int = 4,
    postings_cap: int = 16,
    max_count: int = 128,
    max_count_query: int = 128,
    max_count_target: int = 128,
    route_capacity: Optional[int] = None,
    compact_kw: Optional[dict] = None,
    slots3: Optional[int] = None,
    avg_per_bucket: int = 64,
):
    """END-TO-END query against the hash-range-sharded v2 index: the
    full reference query path (seq_db.rs:1198-1257 + aln.rs:147-242)
    distributed over the mesh with TWO all_to_alls, on the GENERAL
    postings layout (arbitrary per-(key, sid) multiplicity, target
    counts independent of the route payload).

    Per device: sketch the LOCAL queries, compact the pair stream
    (rank-extract, slots2 wide level 2), key-sort the pairs by owner
    range with the original position as payload, ROUTE the 4 key planes
    to their hash-range owners (all_to_all #1).  Owners probe their
    shard's bucketed planes — _shard_probe_planes scatters the postings
    fields (sid, ori<<31|bgn, end) into the same geometry, and the
    shard table is key-sorted before the bucket scatter (both sorts
    stable), so each key's full postings list is ONE contiguous run of
    its 128-wide bucket row, in reference (sid, position) order.  The
    owner compacts that run into `postings_cap` slots (shifted one-hot
    placement off the run's first hit), derives the per-(key, sid)
    occurrence rank m and group size mult from the extracted sid
    sequence (log-shift run propagation over the slot axis), packs the
    single-chip meta word keyovf(1)|mult(7)|m(4)|sid(20)
    (ops/query_e2e.py layout), and ships (meta, bgnori, end) triples —
    3*postings_cap u32 per key, INDEPENDENT of n_targets — back through
    all_to_all #2 in the exact send layout.  The querying device
    unsorts to original pair order and reuses the single-chip
    expand_postings + chain lanes: live per-query and per-(pair, sid)
    count filters (run_len * mult, aln.rs:203-228), (query, target)
    lanes with per-lane q_bgn-sorted anchors, chain_scores_fast.

    Takes (seqs_u8, lengths, rids, *probe_planes[7]) with the planes
    from sharded_index_v2_step (sharded along the axis).  Returns dict
    with anchors (B*n_targets, Pc*M, 6) u32, gvalid, scores, prev (all
    sharded query-major), dup/inexact/mult_ovf (per-group flags),
    row_ovf (per local query: a hit key had > postings_cap postings ->
    whole-query host fallback), and psum'd overflow flags.  Chain
    traceback stays on host (as in the single-chip path).
    """
    from jax import shard_map

    from ..ops.chain import chain_scores_fast
    from ..ops.query_e2e import (
        META_EMPTY as QE_META_EMPTY,
        SID_BITS as QE_SID_BITS,
        M_BITS as QE_M_BITS,
        dup_pair_counts,
        expand_postings,
    )

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    bits = probe_bits_for(shard_capacity, avg_per_bucket)
    C = n_targets
    Pp = postings_cap
    assert Pp <= 127, "postings_cap > 127 overflows the 7-bit mult field"

    def local_step(seqs_u8, lengths, rids, p0, p1, p2, p3, psid, pbgn, pend):
        B_loc = seqs_u8.shape[0]
        xh, xl, yl, valid, c_ovf = _sketch_compact(
            seqs_u8, lengths, rids, k, r, min_span, chunk, compact_kw
        )
        keep = pairs_ops.min_span_filter_gapped(xh, xl, yl, valid, min_span)
        pr = pairs_ops.pair_mers_gapped(
            xh, xl, yl, keep, tie_orientation_one=True
        )
        cp, cvalid, ovf2 = pairs_ops._rank_extract_planes(
            (
                pr["k0_hi"], pr["k0_lo"], pr["k1_hi"], pr["k1_lo"],
                pr["bgn"], pr["end"], pr["orientation"],
            ),
            pr["pair_valid"], 512, slots2,
        )
        q_h0, q_l0, q_h1, q_l1, q_bgn, q_end, q_ori = cp
        Pc = q_h0.shape[1]
        n_loc = B_loc * Pc

        # ---- owner routing: sort pair keys by hash0's top bits --------
        fh0 = q_h0.reshape(-1)
        fl0 = q_l0.reshape(-1)
        fh1 = q_h1.reshape(-1)
        fl1 = q_l1.reshape(-1)
        fva = cvalid.reshape(-1)
        # mask invalid keys on ALL planes and sort by the FULL key
        # (lexicographic over 4 planes = sorted by hash0's top bits too,
        # so owner runs stay contiguous)
        mh0 = jnp.where(fva, fh0, U32(0xFFFFFFFF))
        ml0 = jnp.where(fva, fl0, U32(0xFFFFFFFF))
        mh1 = jnp.where(fva, fh1, U32(0xFFFFFFFF))
        ml1 = jnp.where(fva, fl1, U32(0xFFFFFFFF))
        idx = jnp.arange(n_loc, dtype=jnp.int32)
        sh0, sl0, sh1, sl1, perm = jax.lax.sort(
            (mh0, ml0, mh1, ml1, idx), num_keys=4
        )
        w0s = (sh0 << 8) | (sl0 >> 24)  # hash0 >> 24, 32 bits
        n_valid = fva.sum().astype(jnp.int32)

        # in-query duplicate-pair count filter (aln.rs:203-211), counted
        # per query ROW via the shared helper — a flat count over the
        # local batch would merge duplicate runs from different queries
        # and over-filter (round-3 review finding).  The per-(pair, sid)
        # target filter runs separately inside expand_postings with the
        # true multiplicity (run_len * mult, aln.rs:213-228).
        run_len = dup_pair_counts((q_h0, q_l0, q_h1, q_l1), cvalid)
        count_ok = run_len <= min(max_count, max_count_query)
        # masked to u32: at n_dev=1 the bounds array below is EMPTY
        # (no interior range boundaries), so the wrapped value is
        # never read — without the mask a 1-device mesh failed to
        # trace (2^32 out of uint32 range)
        per = jnp.uint32((((1 << 24) // n_dev) << 8) & 0xFFFFFFFF)
        bounds = jnp.arange(1, n_dev, dtype=jnp.uint32) * per
        offs = jnp.searchsorted(w0s, bounds).astype(jnp.int32)
        off_full = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), offs, n_valid[None]]
        )
        cnt = off_full[1:] - off_full[:-1]
        route_cap = route_capacity or min(
            n_loc, max(128, -(-2 * n_loc // n_dev))
        )
        route_overflow = (cnt > route_cap).any()

        jrow = jnp.arange(route_cap, dtype=jnp.int32)
        send = {kk: [] for kk in ("h0", "l0", "h1", "l1")}
        starts = []
        masks = []
        for d in range(n_dev):  # static: contiguous owner runs
            start = jnp.clip(off_full[d], 0, max(0, n_loc - route_cap))
            gidx = start + jrow
            mask = (gidx >= off_full[d]) & (gidx < off_full[d + 1])
            starts.append(start)
            masks.append(mask)
            for kk, plane in zip(
                ("h0", "l0", "h1", "l1"), (sh0, sl0, sh1, sl1)
            ):
                v = jax.lax.dynamic_slice(plane, (start,), (route_cap,))
                send[kk].append(jnp.where(mask, v, U32(0xFFFFFFFF)))
        buf = {kk: jnp.stack(v) for kk, v in send.items()}
        recv = {
            kk: jax.lax.all_to_all(v, axis, 0, 0).reshape(-1)
            for kk, v in buf.items()
        }

        # ---- owner side: probe + contiguous-run postings compaction ----
        bucket = (recv["l0"] >> (32 - bits)).astype(jnp.int32)
        r0 = jnp.take(p0, bucket, axis=0)
        r1 = jnp.take(p1, bucket, axis=0)
        r2 = jnp.take(p2, bucket, axis=0)
        r3 = jnp.take(p3, bucket, axis=0)
        # padded route slots carry all-ones keys, which would match the
        # all-ones padding slots of the probe rows — mask them out (a
        # real k0_hi is hash0>>32, 24 bits, never all-ones)
        valid_recv = recv["h0"] != U32(0xFFFFFFFF)
        hit = (
            (r0 == recv["h0"][:, None])
            & (r1 == recv["l0"][:, None])
            & (r2 == recv["h1"][:, None])
            & (r3 == recv["l1"][:, None])
            & valid_recv[:, None]
        )  # (Q, W) — all postings of the key, ONE contiguous run
        rsid = jnp.take(psid, bucket, axis=0)
        rbgn = jnp.take(pbgn, bucket, axis=0)
        rend = jnp.take(pend, bucket, axis=0)

        W = hit.shape[1]
        w_iota = jnp.arange(W, dtype=jnp.int32)
        count = hit.sum(axis=1).astype(jnp.int32)  # (Q,)
        keyovf = count > Pp  # > postings_cap signatures -> truncated
        first = jnp.min(
            jnp.where(hit, w_iota[None, :], W), axis=1
        )  # (Q,) run start (W if no hit)

        # compact the run into Pp slots: slot j <- row position first+j.
        # The run is CONTIGUOUS, so this is a per-row variable LEFT
        # SHIFT by `first`: 7 log-steps of constant lane rolls + selects
        # (~40 plane ops) instead of one masked reduce per slot
        # (3*Pp = 96 reduces — measured as the bulk of the v2 path's
        # 2.4 ms overhead at Pp=32).  Positions left of `first` are
        # never hits, so the cyclic wrap carries only masked zeros.
        sh_sid = jnp.where(hit, rsid, U32(0))
        sh_bgn = jnp.where(hit, rbgn, U32(0))
        sh_end = jnp.where(hit, rend, U32(0))
        b = W >> 1  # ladder derived from the row width (first < W)
        shifts = []
        while b:
            shifts.append(b)
            b >>= 1
        for b in shifts:
            take = (first & b) != 0
            sh_sid = jnp.where(
                take[:, None], jnp.roll(sh_sid, -b, axis=1), sh_sid
            )
            sh_bgn = jnp.where(
                take[:, None], jnp.roll(sh_bgn, -b, axis=1), sh_bgn
            )
            sh_end = jnp.where(
                take[:, None], jnp.roll(sh_end, -b, axis=1), sh_end
            )
        e_sid = sh_sid[:, :Pp]      # (Q, Pp)
        e_bgnori = sh_bgn[:, :Pp]
        e_end = sh_end[:, :Pp]
        j_iota = jnp.arange(Pp, dtype=jnp.int32)
        e_valid = j_iota[None, :] < count[:, None]

        # per-(key, sid) occurrence rank m and group size mult from the
        # extracted sid sequence: postings keep (sid, position) order, so
        # same-sid groups are contiguous runs over the slot axis
        prev_sid = jnp.concatenate(
            [jnp.full((e_sid.shape[0], 1), U32(0xFFFFFFFF)), e_sid[:, :-1]],
            axis=1,
        )
        newrun = e_valid & ((j_iota == 0)[None, :] | (e_sid != prev_sid))
        next_valid = jnp.concatenate(
            [e_valid[:, 1:], jnp.zeros((e_valid.shape[0], 1), jnp.bool_)],
            axis=1,
        )
        next_newrun = jnp.concatenate(
            [newrun[:, 1:], jnp.ones((newrun.shape[0], 1), jnp.bool_)],
            axis=1,
        )
        lastrun = e_valid & (next_newrun | ~next_valid)
        run_start = jnp.where(newrun, j_iota[None, :], 0)
        run_end = jnp.where(lastrun, j_iota[None, :], Pp - 1)
        d2 = 1
        while d2 < Pp:  # log-shift propagate run bounds across the run
            run_start = jnp.maximum(
                run_start,
                jnp.concatenate(
                    [
                        jnp.zeros((run_start.shape[0], d2), jnp.int32),
                        run_start[:, :-d2],
                    ],
                    axis=1,
                ),
            )
            run_end = jnp.minimum(
                run_end,
                jnp.concatenate(
                    [
                        run_end[:, d2:],
                        jnp.full((run_end.shape[0], d2), Pp - 1, jnp.int32),
                    ],
                    axis=1,
                ),
            )
            d2 *= 2
        e_m = (j_iota[None, :] - run_start).astype(U32)
        e_mult = (run_end - run_start + 1).astype(U32)

        # single-chip keyovf semantics (ops/query_e2e.py build_index):
        # truncated postings OR an m beyond the 4-bit field -> the whole
        # key is unreliable -> row_ovf/host fallback on the query side
        keyovf = keyovf | (e_valid & (e_m > U32(15))).any(axis=1)

        # single-chip meta word (ops/query_e2e.py): slot 0 carries keyovf
        meta = (
            (keyovf.astype(U32) << 31)[:, None]
            | (jnp.minimum(e_mult, U32(127)) << (QE_SID_BITS + QE_M_BITS))
            | (jnp.minimum(e_m, U32(15)) << QE_SID_BITS)
            | e_sid
        )
        meta = jnp.where(e_valid, meta, U32(QE_META_EMPTY))

        back = jnp.concatenate(
            [meta, e_bgnori, e_end], axis=1
        )  # (Q, 3*Pp)
        NB = 3 * Pp
        back = jax.lax.all_to_all(
            back.reshape(n_dev, route_cap, NB), axis, 0, 0
        )  # (n_dev, route_cap, 3Pp) in the original send layout

        # ---- reassemble into sorted-pair order, then unsort ------------
        hits_sorted = jnp.full((n_loc, NB), U32(QE_META_EMPTY))
        hits_sorted = hits_sorted.at[:, Pp:].set(U32(0))
        for d in range(n_dev):
            cur = jax.lax.dynamic_slice(
                hits_sorted, (starts[d], 0), (route_cap, NB)
            )
            new = jnp.where(masks[d][:, None], back[d], cur)
            hits_sorted = jax.lax.dynamic_update_slice(
                hits_sorted, new, (starts[d], 0)
            )
        # unsort to original pair order: row i <- hits_sorted[perm^-1(i)].
        # A 2-operand argsort + ONE (n_loc, 3Pp) row gather: a
        # (1+3Pp)-operand payload sort would move 97 planes through the
        # sort network (rows here are 3Pp contiguous u32, gathered whole)
        inv = jax.lax.sort(
            (perm, jnp.arange(n_loc, dtype=jnp.int32)), num_keys=1
        )[1]
        hits = jnp.take(hits_sorted, inv, axis=0)  # (n_loc, 3Pp)

        meta_rows = hits[:, :Pp].reshape(B_loc, Pc, Pp)
        bgnori_rows = hits[:, Pp:2 * Pp].reshape(B_loc, Pc, Pp)
        end_rows = hits[:, 2 * Pp:].reshape(B_loc, Pc, Pp)
        base_hit = cvalid & count_ok
        ex = expand_postings(
            meta_rows, bgnori_rows, end_rows, base_hit, run_len,
            C, M, max_count_target,
        )

        N = Pc * M

        def lane(v):  # (B_loc, C, Pc, M) -> (G, N)
            return v.reshape(B_loc * C, N)

        def lane_q(v):  # (B_loc, Pc) -> (G, N)
            return jnp.broadcast_to(
                v[:, None, :, None], (B_loc, C, Pc, M)
            ).reshape(B_loc * C, N)

        t_ori = ex["t_bgnori"] >> 31
        t_bgn = ex["t_bgnori"] & U32(0x7FFFFFFF)
        planes6 = (
            lane_q(q_bgn), lane_q(q_end), lane_q(q_ori),
            lane(t_bgn), lane(ex["t_end"]), lane(t_ori),
        )
        gvalid = lane(ex["hv"])
        lane_ovf = jnp.zeros((B_loc * C,), dtype=jnp.bool_)
        if slots3 is not None and slots3 < N:
            # per-lane anchor compaction before the chain scan (the
            # (Pc, M) lane plane is mostly padding; order-preserving —
            # see ops/query_e2e.py slots3)
            lane_ovf = gvalid.sum(axis=1) > slots3
            planes6, gvalid, _o3 = pairs_ops._rank_extract_planes(
                planes6, gvalid, N, slots3
            )
        anchors = jnp.stack(planes6, axis=-1)
        scores, prev, dup, inexact = chain_scores_fast(
            anchors, gvalid, penalty, -1, False,
            lookback=lookback, max_span=max_span,
        )
        agg = lambda v: jax.lax.psum(v.astype(jnp.int32), axis) > 0
        return dict(
            anchors=anchors,
            gvalid=gvalid,
            scores=scores,
            prev=prev,
            dup=dup,
            inexact=inexact,
            mult_ovf=ex["grp_ovf"].reshape(B_loc * C),
            lane_ovf=lane_ovf,
            row_ovf=ex["row_ovf"],
            n_hits=jax.lax.psum(gvalid.sum(), axis),
            compact_overflow=agg(c_ovf | ovf2),
            route_overflow=agg(route_overflow),
            postings_overflow=agg(ex["row_ovf"].any()),
        )

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis), P(axis),
            P(axis), P(axis), P(axis), P(axis),
            P(axis), P(axis), P(axis),
        ),
        out_specs=dict(
            anchors=P(axis), gvalid=P(axis), scores=P(axis), prev=P(axis),
            dup=P(axis), inexact=P(axis), mult_ovf=P(axis),
            lane_ovf=P(axis), row_ovf=P(axis),
            n_hits=P(),
            compact_overflow=P(), route_overflow=P(), postings_overflow=P(),
        ),
        check_vma=False,
    )
    return jax.jit(sharded)
