"""Native C++ weighted-DFS walk vs the Python walk — bit-identical
output on adversarial random bidirected graphs (score ties, self loops,
reverse-pair edges, multiple components)."""
import random

import pytest

from pgrtk.graph import bundles as gb
from pgrtk.native import api as native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable"
)


def _random_graph(rng, n_pairs, n_edges, max_score):
    """Random skew-symmetric graph over n_pairs (h0,h1) vertices (both
    orientations), with the reverse-complement edge emitted alongside
    each edge like the adjacency builder does."""
    verts = []
    for _ in range(n_pairs):
        h0 = rng.randrange(1 << 24)
        h1 = rng.randrange(1 << 24)
        verts.append((h0, h1))
    g = gb.build_digraph([])
    score = {}
    edges = []
    for _ in range(n_edges):
        a = verts[rng.randrange(len(verts))] + (rng.randrange(2),)
        b = verts[rng.randrange(len(verts))] + (rng.randrange(2),)
        edges.append((0, a, b))
        edges.append((0, gb._rev(b), gb._rev(a)))
    g = gb.build_digraph(edges)
    for v in g.succ:
        # heavy tie collisions: few distinct scores
        score.setdefault(v, rng.randrange(max_score) + 1)
        score.setdefault(gb._rev(v), score[v])
    return g, score


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize(
    "n_pairs,n_edges,max_score", [(40, 120, 3), (300, 900, 4), (500, 2500, 2)]
)
def test_native_walk_matches_python(seed, n_pairs, n_edges, max_score):
    rng = random.Random(seed)
    g, score = _random_graph(rng, n_pairs, n_edges, max_score)
    if not g.succ:
        pytest.skip("empty graph")
    start = next(iter(g.succ))
    py = gb._weighted_dfs_walk_py(g, score, start)
    cc = gb._weighted_dfs_walk_native(g, score, start)
    assert len(py) == len(cc)
    for i, (a, b) in enumerate(zip(py, cc)):
        assert a == b, (i, a, b)


def test_dispatch_threshold_uses_native():
    rng = random.Random(9)
    g, score = _random_graph(rng, 400, 1600, 3)  # >= 512 directed nodes
    assert len(g.succ) >= 512
    start = next(iter(g.succ))
    via_public = gb.weighted_dfs_walk(g, score, start)
    assert via_public == gb._weighted_dfs_walk_py(g, score, start)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_edge_array_path_matches_digraph_path(seed):
    """_walk_from_edges (vectorized intern + CSR + C++ walk) must equal
    the _Digraph + Python walk on sort_adj_list-style inputs."""
    rng = random.Random(seed)
    n_pairs = 200
    pairs = [
        (rng.randrange(1 << 30), rng.randrange(1 << 30))
        for _ in range(n_pairs)
    ]
    frag_map = {p: [None] * (rng.randrange(5) + 1) for p in pairs}
    adj = []
    for _ in range(600):
        a = pairs[rng.randrange(n_pairs)] + (rng.randrange(2),)
        b = pairs[rng.randrange(n_pairs)] + (rng.randrange(2),)
        adj.append((0, a, b))
        adj.append((0, gb._rev(b), gb._rev(a)))
    start = adj[0][1]

    g = gb.build_digraph(adj)
    score = {}
    for _s, v, w in adj:
        score.setdefault(v, len(frag_map[(v[0], v[1])]))
        score.setdefault(w, len(frag_map[(w[0], w[1])]))
    py = gb._weighted_dfs_walk_py(g, score, start)
    arr = gb._walk_from_edges(
        adj, lambda h0, h1: len(frag_map[(h0, h1)]), start
    )
    assert len(py) == len(arr)
    for i, (a, b) in enumerate(zip(py, arr)):
        assert a == b, (i, a, b)


@pytest.mark.parametrize("seed", [21, 22, 23, 24])
@pytest.mark.parametrize("cutoff", [1, 3, 8])
def test_array_bundle_decomposition_matches_python(seed, cutoff):
    """_principal_bundles_from_edges (C++ walk + C++ peel + vectorized
    filtering) must reproduce the dict-based decomposition exactly —
    same paths, same order, same filtered adjacency."""
    rng = random.Random(seed)
    n_pairs = 120
    pairs = [
        (rng.randrange(1 << 30), rng.randrange(1 << 30))
        for _ in range(n_pairs)
    ]
    frag_map = {p: [None] * (rng.randrange(6) + 1) for p in pairs}
    adj = []
    # chains with branches: realistic bundle shapes
    for _ in range(10):
        walk = [pairs[rng.randrange(n_pairs)] + (rng.randrange(2),)
                for _ in range(rng.randrange(3, 25))]
        for a, b in zip(walk, walk[1:]):
            adj.append((0, a, b))
            adj.append((0, gb._rev(b), gb._rev(a)))
    if not adj:
        pytest.skip("empty")

    res_arr = gb._principal_bundles_from_edges(frag_map, adj, cutoff)
    # adj < 4096, so the public function takes the dict-based path
    res_py = gb.get_principal_bundles_from_adj_list(frag_map, adj, cutoff)
    assert res_arr[1] == res_py[1], "filtered adjacency differs"
    assert len(res_arr[0]) == len(res_py[0])
    for a, b in zip(res_arr[0], res_py[0]):
        assert a == b


@pytest.mark.parametrize("seed", [31, 32])
def test_frag_map_direct_decomposition_matches_tuple_path(seed):
    """principal_bundles_from_frag_map (rows -> sort+link -> interned
    edges, no tuple adjacency) must match frag_map_to_adj_list +
    get_principal_bundles_from_adj_list exactly."""
    rng = random.Random(seed)
    frag_map = {}
    sid_pos = {}
    n_pairs = 150
    pairs = [
        (rng.randrange(1 << 30), rng.randrange(1 << 30))
        for _ in range(n_pairs)
    ]
    for sid in range(12):
        pos = 0
        for _ in range(rng.randrange(10, 60)):
            p = pairs[rng.randrange(n_pairs)]
            length = rng.randrange(50, 300)
            frag_map.setdefault(p, []).append(
                (len(frag_map.get(p, [])), sid, pos, pos + length,
                 rng.randrange(2))
            )
            pos += length
        sid_pos[sid] = pos
    adj = gb.frag_map_to_adj_list(frag_map, 1, None)
    if not adj:
        pytest.skip("no adjacency")
    exp = gb.get_principal_bundles_from_adj_list(frag_map, adj, 4)

    # force the array path regardless of size thresholds
    import numpy as np

    from pgrtk.ops import adj as adj_ops

    rows, mask = gb._rows_mask_from_frag_map(frag_map, 1, None)
    srows, link = adj_ops.sort_link_rows(rows, mask)
    res = gb._edges_from_sorted_rows(srows, link)
    assert res is not None
    it, sids, src, dst = res
    start = (int(src[0, 0]), int(src[0, 1]), int(src[0, 2]))
    assert start == adj[0][1]
    principal, emask = gb._principal_bundles_core(
        it, lambda h0, h1: len(frag_map[(h0, h1)]), start, 4
    )
    fe = np.flatnonzero(emask)
    filtered = [
        (s, (v[0], v[1], v[2]), (w[0], w[1], w[2]))
        for s, v, w in zip(
            sids[fe].tolist(), src[fe].tolist(), dst[fe].tolist()
        )
    ]
    assert principal == exp[0]
    assert filtered == exp[1]
