"""MAP-graph construction and principal-bundle decomposition.

Host-side graph algorithms re-deriving the reference semantics:
  - frag_map -> adjacency list (reference: pgr-db/src/seq_db.rs:876-944)
  - per-sequence adjacency list (seq_db.rs:946-1000)
  - weighted bidirected DFS (graph_utils.rs:63-290)
  - principal bundle peeling (seq_db.rs:1063-1186)

Graph traversal is pointer-chasing with a priority queue — the wrong shape
for a batch accelerator; like the reference (which runs it on one CPU thread) we keep
it on host.  Nodes are (hash0, hash1, orientation) tuples; the reverse of
(h0, h1, o) is (h0, h1, 1-o) (skew symmetry).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Set, Tuple

Node = Tuple[int, int, int]  # (hash0, hash1, orientation)
AdjPair = Tuple[int, Node, Node]  # (sid, v, w)


def _rev(v: Node) -> Node:
    return (v[0], v[1], 1 - v[2])


def frag_map_to_adj_list(
    frag_map, min_count: int, keeps: Optional[Sequence[int]] = None
) -> List[AdjPair]:
    """Flatten the index to (sid, bgn, end, node) rows, sort, and link
    consecutive fragments of the same sequence (emitting both the forward
    and the reverse-complement edge).  (reference: seq_db.rs:876-944 —
    a rayon parallel sort there; here the sort+link runs on device for
    large graphs via ops/adj.py, host tuple sort otherwise.)"""
    keep_set = set(keeps) if keeps is not None else None
    n_rows = sum(len(sigs) for sigs in frag_map.values())
    if n_rows < 2:
        return []

    from ..utils import dispatch

    if dispatch.use_device(n_rows, what="adj", min_bases=1 << 18):
        import numpy as np

        from ..ops import adj as adj_ops

        rows, mask = _rows_mask_from_frag_map(frag_map, min_count, keep_set)
        srows, link = adj_ops.sort_link_rows(rows, mask, device=True)
        out: List[AdjPair] = []
        for i in np.flatnonzero(link):
            sid = int(srows[i, 0])
            v = (int(srows[i, 3]), int(srows[i, 4]), int(srows[i, 5]))
            w = (
                int(srows[i + 1, 3]),
                int(srows[i + 1, 4]),
                int(srows[i + 1, 5]),
            )
            out.append((sid, v, w))
            out.append((sid, _rev(w), _rev(v)))
        return out

    rows = []
    for (h0, h1), sigs in frag_map.items():
        for _fid, sid, bgn, end, ori in sigs:
            rows.append((sid, bgn, end, (h0, h1, ori)))
    rows.sort()

    def passes(row):
        if len(frag_map[(row[3][0], row[3][1])]) >= min_count:
            return True
        return keep_set is not None and row[0] in keep_set

    mask = [passes(r) for r in rows]
    out = []
    for i in range(len(rows) - 1):
        if not (mask[i] and mask[i + 1]):
            continue
        v, w = rows[i], rows[i + 1]
        if v[0] != w[0] or v[2] != w[1]:
            continue  # different sequence or non-adjacent fragments
        out.append((v[0], v[3], w[3]))
        out.append((v[0], _rev(w[3]), _rev(v[3])))
    return out


def _rows_mask_from_frag_map(frag_map, min_count: int, keep_set):
    """Flatten a dict frag_map into (n_rows, 6) u64
    (sid, bgn, end, h0, h1, ori) + the min_count/keeps mask."""
    import numpy as np

    n_rows = sum(len(sigs) for sigs in frag_map.values())
    rows = np.empty((n_rows, 6), dtype=np.uint64)
    mask = np.empty(n_rows, dtype=bool)
    i = 0
    for (h0, h1), sigs in frag_map.items():
        ok = len(sigs) >= min_count
        for _fid, sid, bgn, end, ori in sigs:
            rows[i] = (sid, bgn, end, h0, h1, ori)
            mask[i] = ok or (keep_set is not None and sid in keep_set)
            i += 1
    return rows, mask


def generate_smp_adj_list_for_seq(
    seq: bytes, sid: int, frag_map, spec, min_count: int
) -> List[AdjPair]:
    """(reference: seq_db.rs:946-1000)"""
    from ..core import sketch as sketch_mod

    mers = sketch_mod.sequence_to_shmmrs(0, seq, spec, False)
    res = []
    for i in range(len(mers) - 1):
        x0, y0 = mers[i]
        x1, y1 = mers[i + 1]
        s0, s1 = x0 >> 8, x1 >> 8
        p0 = ((y0 & 0xFFFFFFFF) >> 1) + 1
        p1 = ((y1 & 0xFFFFFFFF) >> 1) + 1
        if s0 < s1:
            res.append((s0, s1, p0, p1, 0))
        else:
            res.append((s1, s0, p0, p1, 1))
    out: List[AdjPair] = []
    for i in range(len(res) - 1):
        v = res[i]
        w = res[i + 1]
        cv = frag_map.get((v[0], v[1]))
        cw = frag_map.get((w[0], w[1]))
        if (
            cv is None
            or cw is None
            or len(cv) < min_count
            or len(cw) < min_count
            or v[3] != w[2]
        ):
            continue
        out.append((sid, (v[0], v[1], v[4]), (w[0], w[1], w[4])))
        out.append((sid, (w[0], w[1], 1 - w[4]), (v[0], v[1], 1 - v[4])))
    return out


class _Digraph:
    """Tiny adjacency-map digraph preserving insertion order of neighbors
    (petgraph's DiGraphMap iterates neighbors in insertion order)."""

    __slots__ = ("succ", "pred")

    def __init__(self):
        self.succ: Dict[Node, dict] = {}
        self.pred: Dict[Node, dict] = {}

    def add_edge(self, v: Node, w: Node):
        self.succ.setdefault(v, {})[w] = None
        self.succ.setdefault(w, {})
        self.pred.setdefault(w, {})[v] = None
        self.pred.setdefault(v, {})

    def nodes(self):
        return self.succ.keys()

    def out_neighbors(self, v: Node):
        return self.succ.get(v, {}).keys()

    def in_neighbors(self, v: Node):
        return self.pred.get(v, {}).keys()

    def remove_node(self, v: Node):
        for w in self.succ.pop(v, {}):
            self.pred.get(w, {}).pop(v, None)
        for u in self.pred.pop(v, {}):
            self.succ.get(u, {}).pop(v, None)


def sort_adj_list_by_weighted_dfs(
    frag_map, adj_list: Sequence[AdjPair], start: Node
) -> List[Tuple[Node, Optional[Node], int, bool, int, int, int]]:
    """Weighted bidirected DFS (reference: seq_db.rs:1013-1061 +
    graph_utils.rs:63-290).

    Returns [(node, parent, coverage, is_leaf, rank, branch_id,
    branch_rank)].

    Large graphs skip the Python dict digraph entirely: edges intern to
    ids vectorized and the C++ walk runs over CSR arrays.
    """
    if len(adj_list) >= 4096:
        from ..native import api as native

        if native.available():
            return _walk_from_edges(
                adj_list,
                lambda h0, h1: len(frag_map[(h0, h1)]),
                start,
            )
    g = _Digraph()
    score: Dict[Node, int] = {}
    for _sid, v, w in adj_list:
        g.add_edge(v, w)
        if v not in score:
            score[v] = len(frag_map[(v[0], v[1])])
        if w not in score:
            score[w] = len(frag_map[(w[0], w[1])])
    return weighted_dfs_walk(g, score, start)


class _InternedEdges:
    """Edge list interned to node ids: id = 2*pair_rank + orientation,
    so the skew-symmetric reverse of id is id ^ 1."""

    __slots__ = ("uniq", "ul", "src_id", "dst_id", "n_pairs", "N")


def _intern_pairs(all_pairs, src_ori, dst_ori) -> "_InternedEdges":
    """Intern a stacked (2E, 2) u64 pair array (E src rows then E dst
    rows) plus per-edge orientations into node ids.

    Unique rows via the shared complex128-view lexicographic keys
    (utils/u64pair.py): np.unique on 1-D complex is ~8x faster than
    axis=0 row unique."""
    import numpy as np

    from ..utils.u64pair import pair_ckeys

    ucx, inv = np.unique(pair_ckeys(all_pairs), return_inverse=True)
    it = _InternedEdges()
    it.uniq = ucx.view(np.uint64).reshape(-1, 2)
    it.ul = it.uniq.tolist()  # python ints iterate ~10x faster than rows
    inv = inv.reshape(-1).astype(np.int64)
    E = len(src_ori)
    it.src_id = inv[:E] * 2 + src_ori.astype(np.int64)
    it.dst_id = inv[E:] * 2 + dst_ori.astype(np.int64)
    it.n_pairs = len(it.uniq)
    it.N = 2 * it.n_pairs
    return it


def _intern_edges(adj_list: Sequence[AdjPair]) -> "_InternedEdges":
    import numpy as np

    E = len(adj_list)
    flat = np.fromiter(
        (
            x
            for _s, v, w in adj_list
            for x in (v[0], v[1], v[2], w[0], w[1], w[2])
        ),
        dtype=np.uint64,
        count=6 * E,
    ).reshape(E, 6)
    all_pairs = np.concatenate([flat[:, 0:2], flat[:, 3:5]])
    return _intern_pairs(all_pairs, flat[:, 2], flat[:, 5])


def _csr_from_edges(src_id, dst_id, N: int):
    """First-insertion dedup (Python dict semantics), then stable
    grouping to CSR so per-node neighbor order is insertion order.
    Returns (succ_indptr, succ_idx, pred_indptr, pred_idx)."""
    import numpy as np

    eid = (src_id.astype(np.uint64) << np.uint64(32)) | dst_id.astype(
        np.uint64
    )
    _, first = np.unique(eid, return_index=True)
    keep = np.sort(first)
    s2, d2 = src_id[keep], dst_id[keep]
    order_s = np.argsort(s2, kind="stable")
    succ_idx = d2[order_s].astype(np.uint32)
    succ_indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(np.bincount(s2, minlength=N), out=succ_indptr[1:])
    order_d = np.argsort(d2, kind="stable")
    pred_idx = s2[order_d].astype(np.uint32)
    pred_indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(np.bincount(d2, minlength=N), out=pred_indptr[1:])
    return succ_indptr, succ_idx, pred_indptr, pred_idx


def _start_id(it: "_InternedEdges", start: Node) -> int:
    import numpy as np

    uniq = it.uniq
    lo = int(np.searchsorted(uniq[:, 0], np.uint64(start[0]), "left"))
    hi = int(np.searchsorted(uniq[:, 0], np.uint64(start[0]), "right"))
    p = lo + int(
        np.searchsorted(uniq[lo:hi, 1], np.uint64(start[1]), "left")
    )
    return 2 * p + start[2]


def _edges_from_sorted_rows(srows, link):
    """Interned edges straight from sort_link_rows output — the forward
    edge and its reverse-complement interleaved exactly like the tuple
    builder in frag_map_to_adj_list.  Returns (it, sids (2E,),
    src_nodes (2E, 3) u64, dst_nodes (2E, 3) u64) or None if no links."""
    import numpy as np

    li = np.flatnonzero(link)
    if len(li) == 0:
        return None
    a = srows[li]
    b = srows[li + 1]
    E = len(li)
    src = np.empty((2 * E, 3), dtype=np.uint64)
    dst = np.empty((2 * E, 3), dtype=np.uint64)
    src[0::2] = a[:, 3:6]
    dst[0::2] = b[:, 3:6]
    src[1::2, 0:2] = b[:, 3:5]
    src[1::2, 2] = np.uint64(1) - b[:, 5]
    dst[1::2, 0:2] = a[:, 3:5]
    dst[1::2, 2] = np.uint64(1) - a[:, 5]
    sids = np.repeat(a[:, 0], 2)

    all_pairs = np.concatenate([src[:, 0:2], dst[:, 0:2]])
    it = _intern_pairs(all_pairs, src[:, 2], dst[:, 2])
    return it, sids, src, dst


def _walk_rows_from_edges(
    it: "_InternedEdges", pair_score, start: Node
):
    """Run the C++ walk over interned ids; returns the raw (n, 7) int64
    row array (node/parent as ids)."""
    import numpy as np

    from ..native import api as native

    N = it.N
    # node key table (heap tie-breaks compare the (h0, h1, ori) tuple)
    keys = np.empty((N, 3), dtype=np.uint64)
    keys[0::2, 0:2] = it.uniq
    keys[1::2, 0:2] = it.uniq
    keys[0::2, 2] = 0
    keys[1::2, 2] = 1
    rev = np.arange(N, dtype=np.uint32) ^ np.uint32(1)
    sc_pairs = np.fromiter(
        (pair_score(p[0], p[1]) for p in it.ul),
        dtype=np.int64,
        count=it.n_pairs,
    )
    sc = np.repeat(sc_pairs, 2)
    succ_indptr, succ_idx, pred_indptr, pred_idx = _csr_from_edges(
        it.src_id, it.dst_id, N
    )
    return native.dfs_walk(
        keys, rev, sc, succ_indptr,
        succ_idx if len(succ_idx) else np.zeros(1, np.uint32),
        pred_indptr,
        pred_idx if len(pred_idx) else np.zeros(1, np.uint32),
        _start_id(it, start),
    )


def _walk_from_edges(adj_list: Sequence[AdjPair], pair_score, start: Node):
    """Array-native marshalling for the C++ walk — bit-identical to the
    _Digraph walk; avoids ~2 us/edge of dict construction."""
    it = _intern_edges(adj_list)
    rows = _walk_rows_from_edges(it, pair_score, start)
    ul = it.ul
    out = []
    for r in rows.tolist():
        p0, o0 = r[0] >> 1, r[0] & 1
        node = (ul[p0][0], ul[p0][1], o0)
        if r[1] >= 0:
            p1, o1 = r[1] >> 1, r[1] & 1
            parent = (ul[p1][0], ul[p1][1], o1)
        else:
            parent = None
        out.append((node, parent, r[2], bool(r[3]), r[4], r[5], r[6]))
    return out


def build_digraph(adj_list: Sequence[AdjPair]) -> "_Digraph":
    g = _Digraph()
    for _sid, v, w in adj_list:
        g.add_edge(v, w)
    return g


def _weighted_dfs_walk_native(g: "_Digraph", score, start: Node):
    """Marshal the graph to interned-id CSR arrays (insertion order —
    Python dict semantics ARE the walk-order contract) and run the C++
    walk (native/src/dfs_walk.cc).  Bit-identical output to the Python
    walk below; ~two decades faster at chromosome scale."""
    import numpy as np

    from ..native import api as native

    base = list(g.succ.keys())
    idx: Dict[Node, int] = {v: i for i, v in enumerate(base)}
    nodes = list(base)
    for v in base:
        r = _rev(v)
        if r not in idx:
            idx[r] = len(nodes)
            nodes.append(r)  # virtual: reverse absent from the graph
    N = len(nodes)
    keys = np.asarray(nodes, dtype=np.uint64)
    rev = np.fromiter(
        (idx[_rev(v)] for v in nodes), dtype=np.uint32, count=N
    )
    sc = np.fromiter(
        (score.get(v, 0) for v in nodes), dtype=np.int64, count=N
    )
    succ_indptr = np.zeros(N + 1, dtype=np.int64)
    succ_list: List[int] = []
    pred_indptr = np.zeros(N + 1, dtype=np.int64)
    pred_list: List[int] = []
    for i, v in enumerate(nodes):
        for w in g.succ.get(v, ()):
            succ_list.append(idx[w])
        succ_indptr[i + 1] = len(succ_list)
        for u in g.pred.get(v, ()):
            pred_list.append(idx[u])
        pred_indptr[i + 1] = len(pred_list)
    rows = native.dfs_walk(
        keys,
        rev,
        sc,
        succ_indptr,
        np.asarray(succ_list or [0], dtype=np.uint32),
        pred_indptr,
        np.asarray(pred_list or [0], dtype=np.uint32),
        idx[start],
    )
    out = []
    for r in rows.tolist():
        out.append(
            (
                nodes[r[0]],
                nodes[r[1]] if r[1] >= 0 else None,
                r[2],
                bool(r[3]),
                r[4],
                r[5],
                r[6],
            )
        )
    return out


def weighted_dfs_walk(g: "_Digraph", score: Dict[Node, int], start: Node):
    """The BiDiGraphWeightedDfs walk, with caller-provided scores (used
    directly by the consensus module; reference: graph_utils.rs:63-290).
    Large graphs run the bit-identical C++ walk; small ones stay in
    Python (marshalling latency)."""
    if len(g.succ) >= 512:
        from ..native import api as native

        if native.available():
            return _weighted_dfs_walk_native(g, score, start)
    return _weighted_dfs_walk_py(g, score, start)


def _weighted_dfs_walk_py(g: "_Digraph", score: Dict[Node, int], start: Node):
    out = []
    discovered: Set[Node] = set()
    # max-heap keyed on (score, node) — Rust BinaryHeap pops the largest
    # WeightedNode, whose Ord is on score only; ties pop in heap order.
    # We key on (score, node) for determinism.
    pq: List[Tuple[int, Node]] = []
    next_node: Optional[Tuple[int, Node]] = None
    global_rank: Dict[Node, int] = {start: 0}
    current_branch = 0
    branch_rank_state = 0

    next_node = (score[start], start)

    while True:
        if next_node is not None:
            node = next_node
            branch_rank = branch_rank_state
        else:
            if not pq:
                return out
            neg = heapq.heappop(pq)
            node = (-neg[0], neg[1])
            branch_rank_state = 0
            branch_rank = 0
            current_branch += 1
        branch = current_branch

        if node[1] in discovered:
            next_node = None
            continue
        discovered.add(node[1])
        rnode = _rev(node[1])
        discovered.add(rnode)

        succ_f = []
        for succ in g.out_neighbors(node[1]):
            if node[1] == succ or node[1] == _rev(succ):
                continue
            if succ not in discovered:
                succ_f.append((score[succ], succ))
        succ_r = []
        for succ in g.out_neighbors(rnode):
            if node[1] == succ or node[1] == _rev(succ):
                continue
            if succ not in discovered:
                succ_r.append((score[succ], succ))

        is_leaf = len(succ_f) == 0
        if is_leaf:
            next_node = None
        if succ_f:
            succ_f.sort(key=lambda t: t[0])  # score only (Rust Ord)
            next_node = succ_f.pop()
            for s in succ_f:
                heapq.heappush(pq, (-s[0], s[1]))
        if succ_r:
            for s in succ_r:
                heapq.heappush(pq, (-s[0], s[1]))

        node_rank = None
        p_node = None
        for n in g.in_neighbors(node[1]):
            r = global_rank.get(n)
            if r is not None and (node_rank is None or r < node_rank):
                node_rank = r
                p_node = n
        for n in g.in_neighbors(rnode):
            r = global_rank.get(n)
            if r is not None and (node_rank is None or r < node_rank):
                node_rank = r
                p_node = n
        node_rank = 0 if node_rank is None else node_rank
        node_rank += 1
        global_rank[node[1]] = node_rank
        global_rank[rnode] = node_rank

        branch_rank_state += 1
        out.append(
            (node[1], p_node, score[node[1]], is_leaf, node_rank, branch,
             branch_rank)
        )


def _principal_bundles_core(
    it: "_InternedEdges", pair_score, start: Node, path_len_cutoff: int
):
    """The C++ walk + C++ peel over interned ids, with the path
    filtering / main-vertex / edge-filtering steps vectorized.
    Returns (principal paths as node tuples, filtered-edge mask)."""
    import numpy as np

    from ..native import api as native

    rows = _walk_rows_from_edges(it, pair_score, start)
    ids = rows[:, 0]
    leaf = rows[:, 3] != 0
    # paths split at leaves (a trailing unterminated run is dropped,
    # like the Python loop)
    ends = np.flatnonzero(leaf)
    starts_ = np.concatenate([[0], ends[:-1] + 1]) if len(ends) else []
    main = np.zeros(it.n_pairs, dtype=bool)
    for s_, e_ in zip(starts_, ends):
        if e_ - s_ + 1 > path_len_cutoff:
            main[ids[s_ : e_ + 1] >> 1] = True

    emask = main[it.src_id >> 1] & main[it.dst_id >> 1]
    fs = it.src_id[emask]
    fd = it.dst_id[emask]
    if len(fs) == 0:
        return [], emask

    succ_indptr, succ_idx, pred_indptr, pred_idx = _csr_from_edges(
        fs, fd, it.N
    )
    # node insertion order of the filtered graph (dict key order:
    # first appearance over the interleaved src/dst sequence)
    seq = np.empty(2 * len(fs), dtype=np.int64)
    seq[0::2] = fs
    seq[1::2] = fd
    _, fidx = np.unique(seq, return_index=True)
    order = seq[np.sort(fidx)].astype(np.uint32)

    blob = native.bundle_peel(
        succ_indptr, succ_idx, pred_indptr, pred_idx, order, it.N
    )
    ul = it.ul
    principal: List[List[Node]] = []
    k = 1
    for _ in range(int(blob[0])):
        m = int(blob[k]); k += 1
        path_ids = blob[k : k + m].tolist(); k += m
        principal.append(
            [(ul[i >> 1][0], ul[i >> 1][1], i & 1) for i in path_ids]
        )
    principal.sort(key=len, reverse=True)
    return principal, emask


def _principal_bundles_from_edges(
    frag_map, adj_list: Sequence[AdjPair], path_len_cutoff: int
) -> Tuple[List[List[Node]], List[AdjPair]]:
    """Array-native principal-bundle decomposition from a tuple
    adjacency list.  Bit-identical to the dict-based path below."""
    import numpy as np

    it = _intern_edges(adj_list)
    principal, emask = _principal_bundles_core(
        it,
        lambda h0, h1: len(frag_map[(h0, h1)]),
        adj_list[0][1],
        path_len_cutoff,
    )
    filtered = [adj_list[i] for i in np.flatnonzero(emask)]
    return principal, filtered


def principal_bundles_from_frag_map(
    frag_map, min_count: int, keeps, path_len_cutoff: int
) -> Tuple[List[List[Node]], List[AdjPair]]:
    """Fully array-native decomposition for large graphs: frag_map rows
    -> device/host sort+link -> interned edges -> C++ walk + peel, with
    NO tuple adjacency materialized in between (the tuple round-trip
    costs ~2 us/edge both ways).  Falls back to the tuple pipeline for
    small graphs or without the native runtime.  Returns
    (principal bundles, filtered adjacency tuples)."""
    import numpy as np

    from ..native import api as native
    from ..ops import adj as adj_ops

    keep_set = set(keeps) if keeps is not None else None
    n_rows = sum(len(sigs) for sigs in frag_map.values())
    if n_rows < (1 << 17) or not native.available():
        adj_list = frag_map_to_adj_list(frag_map, min_count, keeps)
        if not adj_list:
            return [], []
        return get_principal_bundles_from_adj_list(
            frag_map, adj_list, path_len_cutoff
        )

    rows, mask = _rows_mask_from_frag_map(frag_map, min_count, keep_set)
    srows, link = adj_ops.sort_link_rows(rows, mask)
    res = _edges_from_sorted_rows(srows, link)
    if res is None:
        return [], []
    it, sids, src, dst = res
    # start node == first edge's source (adj_list[0][1] equivalent)
    start = (int(src[0, 0]), int(src[0, 1]), int(src[0, 2]))
    principal, emask = _principal_bundles_core(
        it,
        lambda h0, h1: len(frag_map[(h0, h1)]),
        start,
        path_len_cutoff,
    )
    fe = np.flatnonzero(emask)
    filtered = [
        (s, (v[0], v[1], v[2]), (w[0], w[1], w[2]))
        for s, v, w in zip(
            sids[fe].tolist(), src[fe].tolist(), dst[fe].tolist()
        )
    ]
    return principal, filtered


def get_principal_bundles_from_adj_list(
    frag_map, adj_list: Sequence[AdjPair], path_len_cutoff: int
) -> Tuple[List[List[Node]], List[AdjPair]]:
    """(reference: seq_db.rs:1063-1186)"""
    assert adj_list
    if len(adj_list) >= 4096:
        from ..native import api as native

        if native.available():
            return _principal_bundles_from_edges(
                frag_map, adj_list, path_len_cutoff
            )
    start = adj_list[0][1]
    sorted_nodes = sort_adj_list_by_weighted_dfs(frag_map, adj_list, start)

    paths: List[List[Node]] = []
    path: List[Node] = []
    for v in sorted_nodes:
        path.append(v[0])
        if v[3]:  # leaf
            paths.append(path)
            path = []

    main_vertices: Set[Tuple[int, int]] = set()
    for p in paths:
        if len(p) > path_len_cutoff:
            for v in p:
                main_vertices.add((v[0], v[1]))

    g0 = _Digraph()
    filtered: List[AdjPair] = []
    for sid, v, w in adj_list:
        if (v[0], v[1]) in main_vertices and (w[0], w[1]) in main_vertices:
            g0.add_edge(v, w)
            filtered.append((sid, v, w))

    terminal: Set[Node] = set()
    for v in list(g0.nodes()):
        # reference marks v as terminal both when v branches out and when
        # some w (a successor) has in-degree > 1 (seq_db.rs:1116-1123 —
        # note it inserts *v* in both cases)
        if len(g0.succ.get(v, {})) > 1:
            terminal.add(v)
        for w in g0.out_neighbors(v):
            if len(g0.pred.get(w, {})) > 1:
                terminal.add(v)

    g1_succ = {v: dict(d) for v, d in g0.succ.items()}
    g1_pred = {v: dict(d) for v, d in g0.pred.items()}

    def g1_remove(v: Node):
        for w in g1_succ.pop(v, {}):
            g1_pred.get(w, {}).pop(v, None)
        for u in g1_pred.pop(v, {}):
            g1_succ.get(u, {}).pop(v, None)

    def find_starts() -> List[Node]:
        return [v for v in g1_succ if not g1_pred.get(v)]

    starts = find_starts()
    if not starts and g1_succ:
        starts = [next(iter(g1_succ))]

    principal: List[List[Node]] = []
    while starts:
        s = starts.pop()
        # plain DFS from s until a terminal vertex is hit
        path = []
        stack = [s]
        seen: Set[Node] = set()
        while stack:
            v = stack.pop()
            if v in seen or v not in g1_succ:
                continue
            seen.add(v)
            path.append(v)
            if v in terminal:
                break
            for w in reversed(list(g1_succ.get(v, {}))):
                if w not in seen:
                    stack.append(w)
        if path:
            for v in path:
                g1_remove(v)
                g1_remove(_rev(v))
            starts = find_starts()
            principal.append(path)
        if not starts and g1_succ:
            starts = [next(iter(g1_succ))]

    principal.sort(key=len, reverse=True)
    return principal, filtered
