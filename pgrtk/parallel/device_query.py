"""Batched device query: sketch a query batch on device, look every canonical
shimmer pair up in the index with the bucketed probe table (ops/probe.py;
~60 ns/query vs a gather-bound binary search), and hand compact hit ids
back to the host for signature expansion + chaining.

This is the scale-out query path (hundreds of queries per dispatch); for
a handful of queries the multi-threaded native host path in
core/query.py has lower latency (no device round trip).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..core import query as query_mod
from ..core.spec import ShmmrSpec


def _device_tables(db):
    """Build (once) and cache the bucketed probe table for the db's
    key-sorted columnar index (ops/probe.py)."""
    import jax.numpy as jnp

    from ..ops import probe as probe_ops

    store = db.frg_db if db.frg_db is not None else db.agc_db
    if store is None:
        raise ValueError("device query needs a columnar (FRG/PGA) backend")
    cached = getattr(db, "_probe_cache", None)
    if cached is None:
        # bucket-ALIGNED fence layout (~1.13x key memory): one row fetch
        # per plane (the dense layout needs two).  This path only
        # consumes `found`, so the padded
        # row positions need no mapping.  A pathological key set can
        # overflow the 128-slot bucket window, in which case the padded
        # layout (which widens W until every bucket fits) serves instead
        try:
            t = probe_ops.build_probe_table_aligned(store.index_keys)
            cached = dict(
                bits=t["bits"],
                planes=[jnp.asarray(t["planes"][i]) for i in range(4)],
                fence=jnp.asarray(t["fence_rows"]),
                aligned=True,
            )
        except ValueError:
            t = probe_ops.build_probe_table(store.index_keys)
            cached = dict(
                bits=t["bits"],
                planes=[jnp.asarray(t["planes"][i]) for i in range(4)],
                row=jnp.asarray(t["row"]),
            )
        db._probe_cache = cached
    return store, cached


def batch_raw_query(db, query_seqs: Sequence[bytes]):
    """Device-batched equivalent of raw_query_fragment for many queries.

    Returns per-query lists of FragmentHit
    ((hash0, hash1), (pos0, pos1, orientation), [signatures]).
    """
    import jax.numpy as jnp

    from ..ops import probe as probe_ops
    from ..ops import sketch as sketch_ops
    from ..ops import sketch1 as sketch1_ops

    spec: ShmmrSpec = db.shmmr_spec
    store, table = _device_tables(db)

    # device sketch (both modes run on device)
    if spec.sketch:
        mers_per_query = [
            list(zip(*xy)) for xy in sketch_ops.sketch_mode2(
                query_seqs, spec=spec
            )
        ]
    else:
        mers_per_query = sketch1_ops.sketch_mode1(query_seqs, spec=spec)

    # canonical pairs per query (host, trivial), then ONE device search
    all_pairs = []
    spans = []
    for mers in mers_per_query:
        pairs = query_mod.pair_shmmrs_canonical(mers)
        spans.append((len(all_pairs), len(pairs)))
        all_pairs.extend(pairs)

    if not all_pairs:
        return [[] for _ in query_seqs]

    arr = np.asarray(all_pairs, dtype=np.uint64)
    q_h0 = jnp.asarray((arr[:, 0] >> np.uint64(32)).astype(np.uint32))
    q_l0 = jnp.asarray((arr[:, 0] & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    q_h1 = jnp.asarray((arr[:, 1] >> np.uint64(32)).astype(np.uint32))
    q_l1 = jnp.asarray((arr[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    if table.get("aligned"):
        found, _row = probe_ops.probe_keys_aligned(
            table, q_h0, q_l0, q_h1, q_l1
        )
    elif "fence" in table:
        found, _row = probe_ops.probe_keys_dense(
            table, q_h0, q_l0, q_h1, q_l1
        )
    else:  # padded-layout fallback (aligned bucket overflow)
        found, _row = probe_ops.probe_keys(table, q_h0, q_l0, q_h1, q_l1)
    found = np.asarray(found)

    # host signature expansion from the columnar blocks
    lookup = db._lookup_fn()
    out: List[list] = []
    for (start, n), _q in zip(spans, query_seqs):
        hits = []
        for i in range(start, start + n):
            s0, s1, p0, p1, ori = all_pairs[i]
            sigs = lookup(int(s0), int(s1)) if found[i] else []
            hits.append(((int(s0), int(s1)), (int(p0), int(p1), int(ori)), sigs))
        out.append(hits)
    return out


def batch_query_to_hps(
    db,
    query_seqs: Sequence[bytes],
    penalty: float = 0.025,
    max_count: int = 128,
    max_count_query: int = 128,
    max_count_target: int = 128,
    max_aln_span: int = 8,
    max_gap=None,
    oriented: bool = False,
    device_chain: bool = True,
    as_arrays: bool = False,
):
    """Device-sketched, device-chained batch version of
    query_fragment_to_hps: sketch + index probe on device, count-filter on
    host, then ONE batched device chain-DP over every (query, target)
    anchor group (ops/chain.py — bit-exact, with per-group host fallback
    when a group's scan exceeds the lookback window).

    as_arrays=True keeps chain tracks as (m, 6) uint32 ndarrays (skips
    the Python tuple decode; see ops.chain.chain_groups)."""
    raw_per_query = batch_raw_query(db, query_seqs)
    if not device_chain:
        return [
            query_mod.query_fragment_to_hps(
                raw, penalty, max_count, max_count_query, max_count_target,
                max_aln_span, max_gap, oriented,
            )
            for raw in raw_per_query
        ]

    from ..ops import chain as chain_ops

    span = 8 if max_aln_span is None else max_aln_span
    groups = []
    layout = []  # (query_idx, sid) aligned with groups
    for qidx, raw in enumerate(raw_per_query):
        th = query_mod.collect_target_hits(
            raw, max_count, max_count_query, max_count_target
        )
        for sid in sorted(s for s in th if len(th[s]) > 1):
            arr = np.asarray(
                [[*a, *b] for a, b in th[sid]], dtype=np.uint32
            )
            groups.append(arr)
            layout.append((qidx, sid))

    chained = chain_ops.chain_groups(
        groups, penalty, max_span=span, max_gap=max_gap, oriented=oriented,
        as_arrays=as_arrays,
    )
    out = [[] for _ in query_seqs]
    for (qidx, sid), chains in zip(layout, chained):
        out[qidx].append((sid, chains))
    return out
