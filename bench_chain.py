"""Batched device chain-DP vs the native host path.

Chains G anchor groups (the per-(query,target) groups of a batch query)
once through ops/chain.py (fast scan kernel + host traceback), once
through the C++ arbiter on a thread pool (the production host path:
ctypes releases the GIL during the call), and once serially.  Prints
one JSON line with groups/s for all three.  Run standalone on a GPU
host, one process per card.
"""
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def make_groups(G: int, N: int, seed: int = 1):
    import numpy as np

    rng = np.random.RandomState(seed)
    groups = []
    for _ in range(G):
        n = int(rng.randint(N // 2, N))
        qb = np.sort(rng.randint(0, 40000, n).astype(np.uint32))
        qe = qb + rng.randint(50, 300, n).astype(np.uint32)
        drift = rng.randint(-200, 200, n).astype(np.int64)
        tb = (qb.astype(np.int64) + drift).clip(0).astype(np.uint32)
        te = tb + (qe - qb)
        g = np.stack(
            [qb, qe, rng.randint(0, 2, n).astype(np.uint32),
             tb, te, rng.randint(0, 2, n).astype(np.uint32)], axis=1
        )
        groups.append(np.ascontiguousarray(g, dtype=np.uint32))
    return groups


def main():
    from pgrtk.native import api as native
    from pgrtk.ops import chain as dchain

    G = int(os.environ.get("BENCH_CHAIN_GROUPS", "10240"))
    N = int(os.environ.get("BENCH_CHAIN_ANCHORS", "128"))
    groups = make_groups(G, N)

    def host_one(g):
        chains = native.sparse_aln(g, 8, 0.025, None, False)
        return [
            (
                score,
                [((int(r[0]), int(r[1]), int(r[2])),
                  (int(r[3]), int(r[4]), int(r[5]))) for r in track],
            )
            for score, track in chains
        ]

    # production representation: tracks stay (m, 6) arrays (pgr-query's
    # merge consumes arrays; tuple decode is benchmarked out)
    dchain.chain_groups(
        groups, 0.025, max_span=8, as_arrays=True
    )  # warm-up compile (same shapes)
    t0 = time.time()
    out_dev = dchain.chain_groups(groups, 0.025, max_span=8, as_arrays=True)
    dt_dev = time.time() - t0
    out_dev = [
        [
            (
                score,
                [((int(r[0]), int(r[1]), int(r[2])),
                  (int(r[3]), int(r[4]), int(r[5]))) for r in track],
            )
            for score, track in chains
        ]
        for chains in out_dev
    ]

    n_threads = os.cpu_count() or 4
    with ThreadPoolExecutor(n_threads) as pool:  # warm-up pool
        pool.map(host_one, groups[:8])
    t0 = time.time()
    with ThreadPoolExecutor(n_threads) as pool:
        out_thr = list(pool.map(host_one, groups))
    dt_thr = time.time() - t0

    t0 = time.time()
    out_ser = [host_one(g) for g in groups[: G // 8]]
    dt_ser = (time.time() - t0) * 8  # extrapolated (serial is slow)

    assert out_dev == out_thr, "device/host mismatch"
    assert out_ser == out_thr[: G // 8]
    print(
        json.dumps(
            {
                "metric": "chain_batch_speedup",
                "value": round(dt_thr / dt_dev, 2),
                "unit": "x vs threaded host",
                "groups": G,
                "anchors_max": N,
                "host_threads": n_threads,
                "device_groups_per_s": round(G / dt_dev, 1),
                "threaded_host_groups_per_s": round(G / dt_thr, 1),
                "serial_host_groups_per_s": round(G / dt_ser, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
