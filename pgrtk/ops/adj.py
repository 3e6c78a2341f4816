"""Construction of the MAP-graph adjacency list from index rows.

The reference builds the adjacency list with a rayon parallel sort over
(sid, bgn, end, node) rows followed by a neighbor scan
(pgr-db/src/seq_db.rs:876-944).  The device equivalent: ONE multi-operand
`lax.sort` over the row planes (56-bit hashes as u32 hi/lo pairs) and a
vectorized shift-compare to find consecutive same-sequence fragment
links.  A numpy lexsort host path serves CPU-only environments — the
row marshalling and link scan are shared, only the sort engine differs,
and jax is imported only when the device path is actually chosen (a
cold jax import costs ~2.7 s of CLI latency).
"""
from __future__ import annotations

import numpy as np

_jit_sort_and_link = None


def _device_sort_and_link():
    global _jit_sort_and_link
    if _jit_sort_and_link is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def _sort_and_link(sid, bgn, end, h0h, h0l, h1h, h1l, ori, mask):
            arrs = jax.lax.sort(
                (sid, bgn, end, h0h, h0l, h1h, h1l, ori, mask.astype(jnp.uint32)),
                num_keys=8,
            )
            sid_s, bgn_s, end_s = arrs[0], arrs[1], arrs[2]
            mask_s = arrs[8].astype(bool)
            link = (
                (sid_s[:-1] == sid_s[1:])
                & (end_s[:-1] == bgn_s[1:])
                & mask_s[:-1]
                & mask_s[1:]
            )
            return arrs, link

        _jit_sort_and_link = _sort_and_link
    return _jit_sort_and_link


def _link_scan(srows: np.ndarray, smask: np.ndarray) -> np.ndarray:
    return (
        (srows[:-1, 0] == srows[1:, 0])
        & (srows[:-1, 2] == srows[1:, 1])
        & smask[:-1]
        & smask[1:]
    )


def sort_link_rows(rows: np.ndarray, mask: np.ndarray, device: bool | None = None):
    """rows: (N, 6) — sid, bgn, end, h0, h1, ori (h0/h1 as u64);
    mask: (N,) bool (min_count / keeps filter, computed by the caller).

    Returns (sorted_rows (N, 6) u64, link (N-1,) bool): sorted by the
    same lexicographic order as the host tuple sort, with link[i] true
    when sorted row i connects to row i+1 (same sid, end == next bgn,
    both unmasked).  `device=None` auto-dispatches on batch size and
    accelerator presence.
    """
    if device is None:
        from ..utils import dispatch

        device = dispatch.use_device(len(rows), what="adj", min_bases=1 << 18)
    if not device:
        order = np.lexsort(
            (rows[:, 5], rows[:, 4], rows[:, 3], rows[:, 2], rows[:, 1], rows[:, 0])
        )
        srows = rows[order]
        return srows, _link_scan(srows, np.asarray(mask)[order])

    import jax.numpy as jnp

    sid = jnp.asarray(rows[:, 0].astype(np.uint32))
    bgn = jnp.asarray(rows[:, 1].astype(np.uint32))
    end = jnp.asarray(rows[:, 2].astype(np.uint32))
    h0 = rows[:, 3]
    h1 = rows[:, 4]
    h0h = jnp.asarray((h0 >> np.uint64(32)).astype(np.uint32))
    h0l = jnp.asarray((h0 & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    h1h = jnp.asarray((h1 >> np.uint64(32)).astype(np.uint32))
    h1l = jnp.asarray((h1 & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    ori = jnp.asarray(rows[:, 5].astype(np.uint32))
    arrs, link = _device_sort_and_link()(
        sid, bgn, end, h0h, h0l, h1h, h1l, ori, jnp.asarray(mask)
    )
    out = np.empty_like(rows)
    out[:, 0] = np.asarray(arrs[0])
    out[:, 1] = np.asarray(arrs[1])
    out[:, 2] = np.asarray(arrs[2])
    out[:, 3] = (np.asarray(arrs[3]).astype(np.uint64) << np.uint64(32)) | (
        np.asarray(arrs[4])
    )
    out[:, 4] = (np.asarray(arrs[5]).astype(np.uint64) << np.uint64(32)) | (
        np.asarray(arrs[6])
    )
    out[:, 5] = np.asarray(arrs[7])
    return out, np.asarray(link)
