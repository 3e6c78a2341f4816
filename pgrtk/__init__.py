"""pgrtk — PanGenomics Research Tool Kit on JAX.

A ground-up re-design of the capabilities of PGR-tk (SHIMMER indexing,
anchor query, sparse chaining, WFA alignment, MAP-graph / principal-bundle
decomposition) for an accelerator: JAX/XLA device kernels for the batched
compute paths, a native C++ runtime for host-side scalar kernels and IO,
and jax.sharding meshes for multi-device scale-out.
"""
from .api import SeqIndexDB, get_principal_bundle_decomposition  # noqa: F401
from .core import ec as _ec
from .core.spec import ShmmrSpec as _ShmmrSpecForEc


def naive_dbg_consensus(seqs, kmer_size=33, min_cov=2):
    """Naive de Bruijn graph consensus (PyO3 surface:
    pgr-tk/src/lib.rs:1857-1885; algorithm core/ec.py <- ec.rs:21-149)."""
    return _ec.naive_dbg_consensus(seqs, kmer_size, min_cov)


def shmmr_dbg_consensus(seqs, w=33, k=33, r=1, min_span=0):
    """Shimmer de Bruijn graph consensus (PyO3 surface:
    pgr-tk/src/lib.rs:1887-1909 — takes w/k/r/min_span and builds a
    sketch=False ShmmrSpec; algorithm core/ec.py <- ec.rs:156-267)."""
    spec = _ShmmrSpecForEc(w=w, k=k, r=r, min_span=min_span, sketch=False)
    return _ec.shmmr_dbg_consensus(seqs, spec)


def guided_shmmr_dbg_consensus(seqs, w=33, k=33, r=1, min_span=0,
                               min_cov=2):
    """Guided shimmer DBG consensus (PyO3 surface:
    pgr-tk/src/lib.rs:1929-1967; algorithm core/ec.py <- ec.rs:274-470)."""
    spec = _ShmmrSpecForEc(w=w, k=k, r=r, min_span=min_span, sketch=False)
    return _ec.guided_shmmr_dbg_consensus(seqs, spec, min_cov)


def shmmr_sparse_aln_consensus(seqs, w=33, k=33, r=1, min_span=0,
                               min_cov=2):
    """Sparse-alignment consensus (PyO3 surface:
    pgr-tk/src/lib.rs:1969-2007; algorithm core/ec.py <- ec.rs:479-508)."""
    spec = _ShmmrSpecForEc(w=w, k=k, r=r, min_span=min_span, sketch=False)
    return _ec.shmmr_sparse_aln_consensus(seqs, spec, min_cov)
from .core.wfa import (  # noqa: F401
    get_variants_from_aln_pair_map,
    wfa_align_bases,
    wfa_aln_pair_map,
)


def get_variant_segments(
    target_str,
    query_str,
    max_wf_length=None,
    mismatch_penalty=4,
    open_penalty=3,
    extension_penalty=1,
    max_diff_percent=0.05,
):
    """Align two sequences (forward) and extract variants + the aligned
    pair map (reference PyO3 surface: pgr-tk/src/lib.rs:1798-1837 —
    NOT pgr-db's internal reversed-suffix get_variant_segments, which
    lives at core.wfa.get_variant_segments / aln.rs:390-453).

    Returns (variants, aln_pairs) or None when the alignment fails or
    the implied divergence exceeds max_diff_percent: with a defaulted
    max_wf_length = max(2*len_diff, 128), any value > 128 whose ratio
    to the shorter sequence exceeds max_diff_percent is rejected before
    aligning (lib.rs:1808-1819)."""
    if isinstance(target_str, (bytes, bytearray)):
        target_str = bytes(target_str).decode()
    if isinstance(query_str, (bytes, bytearray)):
        query_str = bytes(query_str).decode()
    len_diff = abs(len(query_str) - len(target_str))
    if max_wf_length is None:
        max_wf_length = max(2 * len_diff, 128)
    if max_wf_length > 128 and (
        max_wf_length / max(1, min(len(target_str), len(query_str)))
        > max_diff_percent
    ):
        return None
    res = wfa_align_bases(
        target_str, query_str, max_wf_length,
        mismatch_penalty, open_penalty, extension_penalty,
    )
    if res is None:
        return None
    aln_pairs = wfa_aln_pair_map(res[0], res[1])
    return (
        get_variants_from_aln_pair_map(aln_pairs, target_str, query_str),
        aln_pairs,
    )
from .core.fasta import reverse_complement  # noqa: F401
from .core.pga import AGCFile, PgaFile  # noqa: F401
from .core.agc import AgcFile, open_archive  # noqa: F401
from .core.spec import ShmmrSpec  # noqa: F401
from .core.gff_db import GFFDB, GFFRecord  # noqa: F401
from .core.seq_variants import (  # noqa: F401
    get_aln_fragment,
    get_aln_map,
    get_aln_segments,
)


def sparse_aln(sp_hits, max_span, penalty, max_gap=None, orientated=False):
    """Sparse anchor chaining DP (reference: pgr-tk/src/lib.rs:1539-1549)."""
    from .core import aln_ref
    from .native import api as native

    if native.available():
        import numpy as np

        arr = np.asarray([[*a, *b] for a, b in sp_hits], dtype=np.uint32)
        chains = native.sparse_aln(arr, max_span, penalty, max_gap, orientated)
        return [
            (
                score,
                [
                    ((int(r[0]), int(r[1]), int(r[2])),
                     (int(r[3]), int(r[4]), int(r[5])))
                    for r in track
                ],
            )
            for score, track in chains
        ]
    return aln_ref.sparse_aln(list(sp_hits), max_span, penalty, max_gap, orientated)


def get_shmmr_pairs_from_seq(seq, w=80, k=56, r=4, min_span=16, padding=False):
    """Canonical shimmer pairs of a sequence
    (reference: pgr-tk/src/lib.rs:1582-1613)."""
    from .core import query as query_mod
    from .core import sketch as sketch_mod

    spec = ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=False)
    mers = sketch_mod.sequence_to_shmmrs(0, bytes(seq), spec, padding)
    return query_mod.pair_shmmrs_canonical(mers)


def get_shmmr_dots(seq0, seq1, w=80, k=56, r=4, min_span=16):
    """Matched shimmer positions for a dot plot
    (reference: pgr-tk/src/lib.rs:1650-1692)."""
    from .core import sketch as sketch_mod

    spec = ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=False)
    m0 = sketch_mod.sequence_to_shmmrs(0, bytes(seq0), spec, False)
    m1 = sketch_mod.sequence_to_shmmrs(1, bytes(seq1), spec, False)
    base = {}
    for x_, y_ in m0:
        base.setdefault(x_ >> 8, []).append((y_ & 0xFFFFFFFF) >> 1)
    xs, ys = [], []
    for x_, y_ in m1:
        py = (y_ & 0xFFFFFFFF) >> 1
        for px in base.get(x_ >> 8, []):
            xs.append(px)
            ys.append(py)
    return xs, ys


def get_wfa_aln_pair_map(
    target_str,
    query_str,
    max_wf_length=None,
    mismatch_penalty=4,
    open_penalty=3,
    extension_penalty=1,
    max_diff_percent=0.02,
):
    """WFA + pair map with a length-difference guard
    (reference: pgr-tk/src/lib.rs:1737-1772, defaults from the
    pyfunction signature at :1736)."""
    from .core import wfa as wfa_mod

    diff = abs(len(query_str) - len(target_str))
    if max_wf_length is None:
        max_wf_length = max(2 * diff, 128)
    if (
        max_wf_length > 128
        and max_wf_length / min(len(target_str), len(query_str))
        > max_diff_percent
    ):
        return None
    res = wfa_mod.wfa_align_bases(
        target_str,
        query_str,
        max_wf_length,
        mismatch_penalty,
        open_penalty,
        extension_penalty,
    )
    if res is None:
        return None
    return wfa_mod.wfa_aln_pair_map(res[0], res[1])

__version__ = "0.1.0"


def pgr_lib_version() -> str:
    return f"pgrtk {__version__}"


def rc_byte_seq(seq: bytes) -> bytes:
    """Reverse complement of a byte sequence
    (reference: pgr-tk/pgrtk/__init__.py)."""
    return reverse_complement(seq)


def rc_u8_seq(seq: bytes) -> bytes:
    """Alias of rc_byte_seq (reference keeps both names:
    pgr-tk/pgrtk/__init__.py:57)."""
    return reverse_complement(seq)


# the reference's rc() string map is zip("ACGTNnactg", "TGCANntgca") —
# note the LOWERCASE side is typo-ordered ("actg"), so lowercase t -> c
# and g -> a (pgrtk/__init__.py:75).  Replicated bit-for-bit: this repo
# reproduces reference behavior including its quirks; the byte-level
# helpers rc_byte_seq/rc_u8_seq use the reference's CORRECT byte map
# ("acgt" -> "tgca") and are the ones to use on soft-masked sequence.
_RC_STR_MAP = dict(zip("ACGTNnactg", "TGCANntgca"))


def rc(seq: str) -> str:
    return "".join([_RC_STR_MAP[c] for c in seq[::-1]])


def string_to_u8(s: str) -> bytes:
    return s.encode()


def u8_to_string(b: bytes) -> str:
    return bytes(b).decode()


def query_sdb(
    seq_index_db,
    query_seq,
    gap_penalty_factor=0.25,
    merge_range_tol=12,
    max_count=128,
    max_query_count=128,
    max_target_count=128,
    max_aln_span=8,
):
    """Query a sequence index database; returns {sid: [(bgn, end, len,
    orientation, aln)]}.

    Output-parity reimplementation of the reference's public helper
    (pgr-tk/pgrtk/__init__.py:130-221), quirks included:
      * the forward/reverse orientation vote accumulates across ALL
        chains of a target, so a later chain's vote includes every
        earlier chain's hits;
      * a region's bgn/end come from min/max over the (b, e) tuple of
        the first/last SORTED target interval — not over all intervals.
    """
    hits = seq_index_db.query_fragment_to_hps(
        query_seq,
        gap_penalty_factor,
        max_count,
        max_query_count,
        max_target_count,
        max_aln_span,
    )
    oriented_chains = {}
    for sid, chains in hits:
        fwd = rev = 0  # running totals across this target's chains
        for _score, chain in chains:
            if len(chain) <= 2:
                continue
            for (q3, t3) in chain:
                if q3[2] == t3[2]:
                    fwd += 1
                else:
                    rev += 1
            oriented_chains.setdefault(sid, []).append(
                (chain, 0 if fwd > rev else 1)
            )

    regions = {}
    for sid, chains in oriented_chains.items():
        for chain, orientation in chains:
            spans = sorted((t3[0], t3[1]) for _q3, t3 in chain)
            bgn = min(spans[0])
            end = max(spans[-1])
            regions.setdefault(sid, []).append(
                (bgn, end, end - bgn, orientation, chain)
            )
    if merge_range_tol > 0:
        regions = {
            sid: merge_regions(rs, tol=merge_range_tol)
            for sid, rs in regions.items()
        }
    return regions


def merge_regions(rgns, tol=1000):
    """Merge nearby (bgn, end, len, orientation, aln) regions, forward
    and reverse strands separately.

    Parity quirks (reference: pgrtk/__init__.py:270-328): a region whose
    end precedes the current merged end is dropped entirely; merged
    length is the SUM of member lengths (not end - bgn); the proximity
    test uses the previous region's end, which trails the merged end
    after a drop.
    """
    by_strand = ([], [])
    for r in sorted(rgns):
        # any orientation other than 0/1 is silently dropped, exactly as
        # the reference's two strand-filter comprehensions do
        if r[3] in (0, 1):
            by_strand[r[3]].append(list(r))
    out = []
    for strand_rgns in by_strand:
        merged = []
        prev_end = None
        for r in strand_rgns:
            if prev_end is None:
                merged.append(r)
            elif r[1] < merged[-1][1]:
                continue  # contained: dropped, prev_end unchanged
            elif r[0] - prev_end < tol:
                head = merged[-1]
                head[1] = r[1]
                head[2] += r[2]
                head[4] = head[4] + r[4]
            else:
                merged.append(r)
            prev_end = merged[-1][1]
        out.extend(merged)
    return out


def map_intervals_in_sdb(
    seq_index_db,
    interval,
    query_seq,
    gap_penalty_factor=0.001,
    max_count=32,
    max_query_count=32,
    max_target_count=32,
    max_aln_span=8,
):
    """Map a (start, end) interval of query_seq onto database sequences:
    {sid: (orientation, mapped_start, mapped_end)} for targets where both
    endpoints map uniquely with one consistent orientation
    (reference: pgrtk/__init__.py:224-268)."""
    assert len(interval) == 2
    pos_map = seq_index_db.map_positions_in_seq(
        list(interval),
        query_seq,
        gap_penalty_factor,
        max_count,
        max_query_count,
        max_target_count,
        max_aln_span,
    )
    per_target = {}
    for res in pos_map:  # (pos, (sid, tpos, ori), query_span, target_span)
        qpos = res[0]
        sid, tpos, orientation = res[1]
        per_target.setdefault(sid, {}).setdefault(qpos, []).append(
            (tpos, orientation)
        )
    mapped = {}
    for sid, at in per_target.items():
        lefts = at.get(interval[0])
        rights = at.get(interval[1])
        if not lefts or not rights:
            continue
        if len(lefts) != 1 or len(rights) != 1:
            continue  # ambiguous endpoint
        (lp, lo), (rp, ro) = lefts[0], rights[0]
        if lo == ro:
            mapped[sid] = (lo, lp, rp)
    return mapped


def compute_graph_diffusion_entropy(gfa_fn, max_nodes=6000):
    """Diffusion entropy of a GFA graph's link structure.

    Parity quirks (reference: pgrtk/__init__.py:330-388): n is the count
    of DISTINCT linked node ids, and the matrix is indexed by raw id —
    a GFA with id gaps raises IndexError exactly as the reference does;
    the transition matrix divides column j by the sum of ROW j (no
    keepdims — the reference's broadcasting, not a proper row
    normalization); diffusion runs n steps from uniform.
    """
    import numpy as np

    edges = []
    node_ids = set()
    with open(gfa_fn) as f:
        for line in f:
            cols = line.strip().split("\t")
            if cols[0] != "L":
                continue
            a, b = int(cols[1]), int(cols[3])
            weight = 1
            for tag in cols[6:]:
                parts = tag.split(":")
                if parts[0] == "SC":
                    weight = int(parts[2])
            edges.append((a, b, weight))
            node_ids.add(a)
            node_ids.add(b)
    n_node = len(node_ids)
    if n_node > max_nodes:
        return None
    adj = np.zeros((n_node, n_node), dtype=np.float32)
    for a, b, weight in edges:
        adj[a, b] = weight
        adj[b, a] = weight
    transition = adj / np.sum(adj, axis=1)  # reference broadcasting quirk
    yy = np.ones(n_node, dtype=np.float32) / n_node
    for _ in range(n_node):
        yy = transition @ yy
    entropy = -np.sum(yy * np.log2(yy))
    return (entropy, list(enumerate(yy * n_node)))


def group_smps_by_principle_bundle_id(smps, len_cutoff=2500, merge_length=5000):
    """Partition a sequence's (smp, bundle_info) decomposition stream
    into runs of one bundle id + direction, then merge adjacent runs of
    the same (id, direction) closer than merge_length
    (reference: pgrtk/__init__.py:391-467).

    Runs shorter than len_cutoff (end of last smp minus start of first)
    are discarded at the cut points, exactly as the reference does —
    including the final run.
    """
    runs = []
    run = []
    run_key = None  # (bundle_id, direction)

    def keep(r):
        return r and r[-1][0][3] - r[0][0][2] > len_cutoff

    for smp, bundle_info in smps:
        if bundle_info is None:
            continue
        bid, b_ori, bpos = bundle_info[0], bundle_info[1], bundle_info[2]
        direction = 0 if smp[4] == b_ori else 1
        if run_key is None:
            run = [(smp, bid, direction, bpos)]
            run_key = (bid, direction)
            continue
        if (bid, direction) != run_key:
            if keep(run):
                runs.append(run)
            run = []
            run_key = (bid, direction)
        run.append((smp, bid, direction, bpos))
    if keep(run):
        runs.append(run)

    if not runs:
        return []
    merged = []
    current = runs[0]
    for nxt in runs[1:]:
        same_bundle = (
            current[-1][1] == nxt[0][1] and current[-1][2] == nxt[0][2]
        )
        gap = abs(nxt[0][0][2] - current[-1][0][3])
        if same_bundle and gap < merge_length:
            current.extend(nxt)
        else:
            merged.append(current)
            current = nxt
    merged.append(current)
    return merged


def get_principle_bundle_bed_file_for_query(
    seqs, w=64, k=56, r=4, min_span=32, min_cov=2, min_branch_length=8
):
    """Index a list of (name, seq) pairs in memory, decompose into
    principal bundles, and emit BED-style rows mapped back to original
    coordinates parsed from the `..._bgn_end_ori` sequence-name suffix
    (reference: pgrtk/__init__.py:470-506; partitions are emitted in
    reverse order, as the reference does)."""
    sdb = SeqIndexDB()
    sdb.load_from_seq_list(seqs, "memory", w, k, r, min_span)
    _bundles, sid_smps = sdb.get_principal_bundle_decomposition(
        min_cov, min_branch_length
    )
    sid_smps = dict(sid_smps)
    rows = []
    for sid, (ctg, _src, _len) in sorted(
        sdb.seq_info.items(), key=lambda kv: kv[1][0]
    ):
        ctg_bgn = int(ctg.split("_")[-3])
        partitions = group_smps_by_principle_bundle_id(
            sid_smps[sid], 50, 100000
        )
        for p in reversed(partitions):
            bgn = p[0][0][2]
            end = p[-1][0][3] + k
            bid, direction = p[0][1], p[0][2]
            rows.append(
                (
                    ctg,
                    ctg_bgn + bgn,
                    ctg_bgn + end,
                    f"{bid}:{direction}:{p[0][3]}:{p[-1][3]}",
                )
            )
    return rows
