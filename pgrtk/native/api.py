"""ctypes bindings to the native runtime library (libpgrtk.so).

The library is built lazily via make on first use.  pybind11 is not
available in this environment, so the C ABI + ctypes is the binding layer.
Concurrent processes (e.g. pytest-xdist workers importing at once) take an
exclusive file lock around the staleness check, the build and the load,
so none opens a library another is still writing.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libpgrtk.so")
_BUILD_LOCK = os.path.join(_DIR, ".build.lock")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _Spec(ctypes.Structure):
    _fields_ = [
        ("w", ctypes.c_uint32),
        ("k", ctypes.c_uint32),
        ("r", ctypes.c_uint32),
        ("min_span", ctypes.c_uint32),
        ("sketch", ctypes.c_int32),
        ("padding", ctypes.c_int32),
    ]


class _MM128(ctypes.Structure):
    _fields_ = [("x", ctypes.c_uint64), ("y", ctypes.c_uint64)]


class _Delta(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_uint32),
        ("y", ctypes.c_uint32),
        ("dk", ctypes.c_int32),
    ]


class _Ovlp(ctypes.Structure):
    _fields_ = [
        ("m_size", ctypes.c_uint32),
        ("dist", ctypes.c_uint32),
        ("bgn0", ctypes.c_uint32),
        ("end0", ctypes.c_uint32),
        ("bgn1", ctypes.c_uint32),
        ("end1", ctypes.c_uint32),
        ("m_end0", ctypes.c_uint32),
        ("m_end1", ctypes.c_uint32),
        ("deltas", ctypes.POINTER(_Delta)),
        ("n_deltas", ctypes.c_int64),
        ("matched", ctypes.c_int32),
    ]


def _build() -> bool:
    srcs = [
        os.path.join(_DIR, "src", f)
        for f in os.listdir(os.path.join(_DIR, "src"))
        if f.endswith((".cc", ".h"))
    ]
    if os.path.exists(_LIB_PATH):
        lib_mtime = os.path.getmtime(_LIB_PATH)
        if all(os.path.getmtime(s) <= lib_mtime for s in srcs):
            return True
    try:
        subprocess.run(
            ["make", "-j", str(os.cpu_count() or 4)],
            cwd=_DIR,
            check=True,
            capture_output=True,
        )
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        out = getattr(e, "stderr", b"")
        raise RuntimeError(
            f"native build failed: {out.decode() if out else e}"
        ) from e


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(_BUILD_LOCK, "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            if not _build():
                return None
            lib = ctypes.CDLL(_LIB_PATH)
        lib.pgr_sketch.restype = ctypes.c_int64
        lib.pgr_sketch.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_uint32,
            ctypes.POINTER(_Spec),
            ctypes.POINTER(ctypes.POINTER(_MM128)),
        ]
        lib.pgr_sketch_batch.restype = None
        lib.pgr_sketch_batch.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.uint32),
            ctypes.c_int64,
            ctypes.POINTER(_Spec),
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(_MM128)),
            np.ctypeslib.ndpointer(np.int64),
        ]
        lib.pgr_free.restype = None
        lib.pgr_free.argtypes = [ctypes.c_void_p]
        lib.pgr_match_reads.restype = None
        lib.pgr_match_reads.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.POINTER(_Ovlp),
        ]
        lib.pgr_sparse_aln.restype = ctypes.c_int64
        lib.pgr_sparse_aln.argtypes = [
            np.ctypeslib.ndpointer(np.uint32),
            ctypes.c_int64,
            ctypes.c_uint32,
            ctypes.c_float,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pgr_chain_traceback.restype = None
        lib.pgr_chain_traceback.argtypes = [
            np.ctypeslib.ndpointer(np.uint32),
            np.ctypeslib.ndpointer(np.uint8),
            np.ctypeslib.ndpointer(np.float32),
            np.ctypeslib.ndpointer(np.int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pgr_mdb_scan.restype = ctypes.c_int
        lib.pgr_mdb_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.pgr_frg_base_lens.restype = ctypes.c_int64
        lib.pgr_frg_base_lens.argtypes = [
            np.ctypeslib.ndpointer(np.uint8),   # frg blob (after magic)
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),   # group offsets
            np.ctypeslib.ndpointer(np.int64),   # group sizes
            ctypes.c_int64,                     # n_groups
            ctypes.c_int64,                     # chunk
            ctypes.c_int64,                     # k
            ctypes.c_int64,                     # fid_bgn
            ctypes.c_int64,                     # fid_end
            np.ctypeslib.ndpointer(np.int64),   # out lens
        ]
        lib.pgr_frg_sub_bases.restype = ctypes.c_int64
        lib.pgr_frg_sub_bases.argtypes = [
            np.ctypeslib.ndpointer(np.uint8),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8),   # out bases
            ctypes.c_int64,                     # out cap
        ]
        lib.pgr_probe_align_starts.restype = ctypes.c_int64
        lib.pgr_probe_align_starts.argtypes = [
            np.ctypeslib.ndpointer(np.int64),  # counts (nb,)
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),  # starts out (nb,)
        ]
        lib.pgr_dfs_walk.restype = None
        lib.pgr_dfs_walk.argtypes = [
            np.ctypeslib.ndpointer(np.uint64),   # node_keys (n, 3)
            np.ctypeslib.ndpointer(np.uint32),   # rev (n,)
            np.ctypeslib.ndpointer(np.int64),    # score (n,)
            np.ctypeslib.ndpointer(np.int64),    # succ_indptr (n+1,)
            np.ctypeslib.ndpointer(np.uint32),   # succ_idx
            np.ctypeslib.ndpointer(np.int64),    # pred_indptr (n+1,)
            np.ctypeslib.ndpointer(np.uint32),   # pred_idx
            ctypes.c_int64,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pgr_bundle_peel.restype = None
        lib.pgr_bundle_peel.argtypes = [
            np.ctypeslib.ndpointer(np.int64),    # succ_indptr (n+1,)
            np.ctypeslib.ndpointer(np.uint32),   # succ_idx
            np.ctypeslib.ndpointer(np.int64),    # pred_indptr (n+1,)
            np.ctypeslib.ndpointer(np.uint32),   # pred_idx
            np.ctypeslib.ndpointer(np.uint32),   # order (insertion)
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        return _load() is not None
    except RuntimeError:
        return False


def _to_spec(spec, padding: bool) -> _Spec:
    return _Spec(
        w=spec.w,
        k=spec.k,
        r=spec.r,
        min_span=spec.min_span,
        sketch=1 if spec.sketch else 0,
        padding=1 if padding else 0,
    )


def _mm_to_list(ptr, n) -> List[Tuple[int, int]]:
    if n == 0:
        return []
    arr = np.ctypeslib.as_array(ptr, shape=(n,))
    # bulk .tolist() (C-speed u64 -> int) + zip beats per-element numpy
    # scalar conversion ~8x — sketching tuple marshalling was a visible
    # slice of the pbundle CLI profile
    return list(zip(arr["x"].tolist(), arr["y"].tolist()))


def sequence_to_shmmrs(rid: int, seq: bytes, spec, padding: bool = False):
    lib = _load()
    out = ctypes.POINTER(_MM128)()
    cs = _to_spec(spec, padding)
    n = lib.pgr_sketch(bytes(seq), len(seq), rid, ctypes.byref(cs), ctypes.byref(out))
    res = _mm_to_list(out, n)
    lib.pgr_free(out)
    return res


def sequence_to_shmmrs_arrays(rid: int, seq: bytes, spec, padding: bool = False):
    """Like sequence_to_shmmrs but returns (x, y) uint64 numpy arrays."""
    lib = _load()
    out = ctypes.POINTER(_MM128)()
    cs = _to_spec(spec, padding)
    n = lib.pgr_sketch(bytes(seq), len(seq), rid, ctypes.byref(cs), ctypes.byref(out))
    if n:
        arr = np.ctypeslib.as_array(out, shape=(n,))
        x = arr["x"].copy()
        y = arr["y"].copy()
    else:
        x = np.empty(0, np.uint64)
        y = np.empty(0, np.uint64)
    lib.pgr_free(out)
    return x, y


def batch_sequence_to_shmmrs(
    seqs: Sequence[Tuple[int, bytes]], spec, padding: bool = False, nthreads: int = 0
):
    lib = _load()
    n = len(seqs)
    if n == 0:
        return []
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, (_, s) in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    buf = b"".join(bytes(s) for _, s in seqs)
    rids = np.asarray([rid for rid, _ in seqs], dtype=np.uint32)
    outs = (ctypes.POINTER(_MM128) * n)()
    counts = np.zeros(n, dtype=np.int64)
    cs = _to_spec(spec, padding)
    lib.pgr_sketch_batch(
        buf, offsets, rids, n, ctypes.byref(cs), nthreads, outs, counts
    )
    res = []
    for i in range(n):
        res.append(_mm_to_list(outs[i], int(counts[i])))
        lib.pgr_free(outs[i])
    return res


def batch_sequence_to_shmmrs_arrays(
    seqs: Sequence[Tuple[int, bytes]], spec, padding: bool = False, nthreads: int = 0
):
    """Batch sketch returning per-seq (x, y) uint64 numpy array pairs."""
    lib = _load()
    n = len(seqs)
    if n == 0:
        return []
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, (_, s) in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    buf = b"".join(bytes(s) for _, s in seqs)
    rids = np.asarray([rid for rid, _ in seqs], dtype=np.uint32)
    outs = (ctypes.POINTER(_MM128) * n)()
    counts = np.zeros(n, dtype=np.int64)
    cs = _to_spec(spec, padding)
    lib.pgr_sketch_batch(
        buf, offsets, rids, n, ctypes.byref(cs), nthreads, outs, counts
    )
    res = []
    for i in range(n):
        c = int(counts[i])
        if c:
            arr = np.ctypeslib.as_array(outs[i], shape=(c,))
            res.append((arr["x"].copy(), arr["y"].copy()))
        else:
            res.append((np.empty(0, np.uint64), np.empty(0, np.uint64)))
        lib.pgr_free(outs[i])
    return res


def reduce_and_filter_arrays(
    xs, ys, r: int, min_span: int, padding: bool = False
):
    """reduce_and_filter over (x, y) uint64 numpy arrays, zero per-mer
    Python: the input buffer is built with two vectorized stores into a
    structured array and the result is read back as one flat u64 view.
    At batch scale the tuple path costs ~1.5 us/mer of marshalling —
    more than the device sketch kernel itself."""
    import numpy as np

    lib = _load()
    if not getattr(lib, "_raf_configured", False):
        lib.pgr_reduce_and_filter.restype = ctypes.c_int64
        lib.pgr_reduce_and_filter.argtypes = [
            ctypes.POINTER(_MM128),
            ctypes.c_int64,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(_MM128)),
        ]
        lib._raf_configured = True
    n = len(xs)
    buf = np.empty(max(n, 1), dtype=np.dtype([("x", "<u8"), ("y", "<u8")]))
    buf["x"][:n] = xs
    buf["y"][:n] = ys
    out = ctypes.POINTER(_MM128)()
    m = lib.pgr_reduce_and_filter(
        buf.ctypes.data_as(ctypes.POINTER(_MM128)), n, r, min_span,
        1 if padding else 0, ctypes.byref(out),
    )
    if m:
        p64 = ctypes.cast(out, ctypes.POINTER(ctypes.c_uint64))
        flat = np.ctypeslib.as_array(p64, shape=(2 * int(m),)).copy()
        x_out, y_out = flat[0::2], flat[1::2]
    else:
        x_out = np.zeros(0, dtype=np.uint64)
        y_out = np.zeros(0, dtype=np.uint64)
    lib.pgr_free(out)
    return x_out, y_out


def reduce_and_filter(mers, r: int, min_span: int, padding: bool = False):
    """Hierarchical reduction x2 + min_span filter on an emitted mer stream
    (the tail of mode-1 sketching; reference: shmmrutils.rs:359-415,
    533-555)."""
    lib = _load()
    if not getattr(lib, "_raf_configured", False):
        lib.pgr_reduce_and_filter.restype = ctypes.c_int64
        lib.pgr_reduce_and_filter.argtypes = [
            ctypes.POINTER(_MM128),
            ctypes.c_int64,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(_MM128)),
        ]
        lib._raf_configured = True
    n = len(mers)
    arr = (_MM128 * max(n, 1))()
    for i, (x, y) in enumerate(mers):
        arr[i].x = x
        arr[i].y = y
    out = ctypes.POINTER(_MM128)()
    m = lib.pgr_reduce_and_filter(
        arr, n, r, min_span, 1 if padding else 0, ctypes.byref(out)
    )
    res = _mm_to_list(out, m)
    lib.pgr_free(out)
    return res


def match_reads(
    seq0: bytes,
    seq1: bytes,
    get_delta: bool = True,
    tol: float = 0.1,
    min_match_len: int = 0,
    min_match_start: int = 0,
    bandwidth: int = 32,
):
    """Returns None or dict mirroring the reference OvlpMatch."""
    lib = _load()
    ovlp = _Ovlp()
    lib.pgr_match_reads(
        bytes(seq0),
        len(seq0),
        bytes(seq1),
        len(seq1),
        1 if get_delta else 0,
        tol,
        min_match_len,
        min_match_start,
        bandwidth,
        ctypes.byref(ovlp),
    )
    if not ovlp.matched:
        return None
    deltas = None
    if get_delta:
        nd = int(ovlp.n_deltas)
        deltas = [
            (ovlp.deltas[i].x, ovlp.deltas[i].y, ovlp.deltas[i].dk)
            for i in range(nd)
        ]
        lib.pgr_free(ovlp.deltas)
    return {
        "m_size": ovlp.m_size,
        "dist": ovlp.dist,
        "bgn0": ovlp.bgn0,
        "end0": ovlp.end0,
        "bgn1": ovlp.bgn1,
        "end1": ovlp.end1,
        "m_end0": ovlp.m_end0,
        "m_end1": ovlp.m_end1,
        "deltas": deltas,
    }


def sparse_aln(
    hits: np.ndarray,
    max_span: int = 8,
    penalty: float = 0.5,
    max_gap: Optional[int] = None,
    oriented: bool = False,
):
    """hits: (n, 6) uint32. Returns list of (score, (m, 6) uint32 array)."""
    lib = _load()
    hits = np.ascontiguousarray(hits, dtype=np.uint32)
    n = hits.shape[0]
    out = ctypes.POINTER(ctypes.c_uint32)()
    out_len = ctypes.c_int64()
    lib.pgr_sparse_aln(
        hits.reshape(-1),
        n,
        max_span,
        penalty,
        -1 if max_gap is None else max_gap,
        1 if oriented else 0,
        ctypes.byref(out),
        ctypes.byref(out_len),
    )
    blob = np.ctypeslib.as_array(out, shape=(out_len.value,)).copy()
    lib.pgr_free(out)
    chains = []
    p = 0
    n_chains = int(blob[p]); p += 1
    for _ in range(n_chains):
        score = float(blob[p : p + 1].view(np.float32)[0]); p += 1
        m = int(blob[p]); p += 1
        track = blob[p : p + 6 * m].reshape(m, 6).copy(); p += 6 * m
        chains.append((score, track))
    return chains


def chain_traceback(
    anchors: np.ndarray,
    valid: np.ndarray,
    scores: np.ndarray,
    prev: np.ndarray,
    as_arrays: bool = False,
):
    """Batched best-first chain extraction from device chain-DP planes
    (native/src/chain_tb.cc), value-dedup semantics per the reference's
    aln.rs:105-141.  Bit-identical to ops.chain.traceback but runs the
    whole batch in C++ so the device chain path is not floored by host
    post-processing.

    anchors: (G, N, 6) uint32; valid: (G, N); scores: (G, N) f32;
    prev: (G, N) i32.  Returns per group [(score, [(q, t), ...])], or
    with as_arrays=True [(score, track (m, 6) uint32)] — ~1.7 us/anchor
    of Python tuple building skipped; rows are
    (q_bgn, q_end, q_ori, t_bgn, t_end, t_ori).
    """
    lib = _load()
    G, N = scores.shape
    anchors = np.ascontiguousarray(anchors, dtype=np.uint32)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    prev = np.ascontiguousarray(prev, dtype=np.int32)
    out = ctypes.POINTER(ctypes.c_uint32)()
    out_len = ctypes.c_int64()
    lib.pgr_chain_traceback(
        anchors.reshape(-1),
        valid.reshape(-1),
        scores.reshape(-1),
        prev.reshape(-1),
        G,
        N,
        ctypes.byref(out),
        ctypes.byref(out_len),
    )
    blob = np.ctypeslib.as_array(out, shape=(out_len.value,)).copy()
    lib.pgr_free(out)
    if as_arrays:
        floats = blob.view(np.float32)
        results = []
        p = 0
        for _ in range(G):
            n_chains = int(blob[p]); p += 1
            chains = []
            for _ in range(n_chains):
                score = float(floats[p]); p += 1
                m6 = 6 * int(blob[p]); p += 1
                chains.append((score, blob[p : p + m6].reshape(-1, 6)))
                p += m6
            results.append(chains)
        return results
    # Decode via ONE bulk .tolist() pass (C-speed u32 -> Python int); the
    # earlier per-element numpy scalar indexing cost ~1.3 s at G=4096 and
    # dominated the whole device chain path (the C++ extraction above is
    # ~160 ms at that scale).
    ints = blob.tolist()
    floats = blob.view(np.float32)
    results = []
    p = 0
    for _ in range(G):
        n_chains = ints[p]; p += 1
        chains = []
        for _ in range(n_chains):
            score = float(floats[p]); p += 1
            m6 = 6 * ints[p]; p += 1
            t = ints[p : p + m6]; p += m6
            chains.append(
                (
                    score,
                    [
                        ((t[j], t[j + 1], t[j + 2]),
                         (t[j + 3], t[j + 4], t[j + 5]))
                        for j in range(0, m6, 6)
                    ],
                )
            )
        results.append(chains)
    return results


def dfs_walk(
    node_keys: np.ndarray,
    rev: np.ndarray,
    score: np.ndarray,
    succ_indptr: np.ndarray,
    succ_idx: np.ndarray,
    pred_indptr: np.ndarray,
    pred_idx: np.ndarray,
    start: int,
) -> np.ndarray:
    """Weighted bidirected DFS over interned node ids
    (native/src/dfs_walk.cc; reference walk graph_utils.rs:63-290).
    Returns (n_rows, 7) int64:
    (node, parent|-1, score, is_leaf, rank, branch, branch_rank)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_int64)()
    out_len = ctypes.c_int64()
    lib.pgr_dfs_walk(
        np.ascontiguousarray(node_keys, dtype=np.uint64),
        np.ascontiguousarray(rev, dtype=np.uint32),
        np.ascontiguousarray(score, dtype=np.int64),
        np.ascontiguousarray(succ_indptr, dtype=np.int64),
        np.ascontiguousarray(succ_idx, dtype=np.uint32),
        np.ascontiguousarray(pred_indptr, dtype=np.int64),
        np.ascontiguousarray(pred_idx, dtype=np.uint32),
        len(rev),
        int(start),
        ctypes.byref(out),
        ctypes.byref(out_len),
    )
    blob = np.ctypeslib.as_array(out, shape=(out_len.value,)).copy()
    lib.pgr_free(out)
    return blob.reshape(-1, 7)


def bundle_peel(
    succ_indptr: np.ndarray,
    succ_idx: np.ndarray,
    pred_indptr: np.ndarray,
    pred_idx: np.ndarray,
    order: np.ndarray,
    n_nodes: int,
) -> np.ndarray:
    """Principal-bundle peel loop over interned ids
    (native/src/bundle_peel.cc; reference seq_db.rs:1086-1183).
    Returns the flat blob [n_paths, then per path: len, ids...]."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_int64)()
    out_len = ctypes.c_int64()
    lib.pgr_bundle_peel(
        np.ascontiguousarray(succ_indptr, dtype=np.int64),
        np.ascontiguousarray(succ_idx, dtype=np.uint32),
        np.ascontiguousarray(pred_indptr, dtype=np.int64),
        np.ascontiguousarray(pred_idx, dtype=np.uint32),
        np.ascontiguousarray(order, dtype=np.uint32),
        int(n_nodes),
        len(order),
        ctypes.byref(out),
        ctypes.byref(out_len),
    )
    blob = np.ctypeslib.as_array(out, shape=(out_len.value,)).copy()
    lib.pgr_free(out)
    return blob


def mdb_scan(path: str):
    """Offsets-only walk of a .mdb file (reference lazy load,
    seq_db.rs:1409-1504): returns (spec, keys (n,2) u64, byte_starts
    (n,) i64, counts (n,) i64) without touching posting bytes."""
    from ..core.spec import ShmmrSpec

    lib = _load()
    header = (ctypes.c_uint32 * 5)()
    keys_p = ctypes.POINTER(ctypes.c_uint64)()
    starts_p = ctypes.POINTER(ctypes.c_int64)()
    counts_p = ctypes.POINTER(ctypes.c_int64)()
    nkeys = ctypes.c_uint64()
    rc = lib.pgr_mdb_scan(
        path.encode(),
        header,
        ctypes.byref(keys_p),
        ctypes.byref(starts_p),
        ctypes.byref(counts_p),
        ctypes.byref(nkeys),
    )
    if rc != 0:
        raise IOError(f"pgr_mdb_scan({path}) failed with {rc}")
    n = nkeys.value
    if n:
        keys = np.ctypeslib.as_array(keys_p, shape=(n, 2)).copy()
        starts = np.ctypeslib.as_array(starts_p, shape=(n,)).copy()
        counts = np.ctypeslib.as_array(counts_p, shape=(n,)).copy()
    else:
        keys = np.empty((0, 2), dtype=np.uint64)
        starts = np.empty(0, dtype=np.int64)
        counts = np.empty(0, dtype=np.int64)
    lib.pgr_free(keys_p)
    lib.pgr_free(starts_p)
    lib.pgr_free(counts_p)
    spec = ShmmrSpec(
        w=header[0], k=header[1], r=header[2], min_span=header[3],
        sketch=(header[4] & 1) == 1,
    )
    return spec, keys, starts, counts


def probe_align_starts(counts: np.ndarray):
    """Bucket-padding scan for the aligned probe layout (native; the
    sequential recurrence costs ~8 s in Python at 32M keys — see
    ops/probe.py::build_probe_table_aligned).  Returns (starts (nb,)
    int64, n_padded).  None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    starts = np.empty(len(counts), dtype=np.int64)
    n_padded = lib.pgr_probe_align_starts(counts, len(counts), starts)
    return starts, int(n_padded)


def frg_base_lens(frg_arr, grp_off, grp_size, chunk, k, fid_bgn, fid_end):
    """Per-fragment contributed lengths from the .frg blob (header parse
    only).  None if the native library is unavailable or parsing fails."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(fid_end - fid_bgn, dtype=np.int64)
    rc = lib.pgr_frg_base_lens(
        frg_arr, len(frg_arr), grp_off, grp_size, len(grp_off),
        chunk, k, fid_bgn, fid_end, out,
    )
    return out if rc == 0 else None


def frg_sub_bases(frg_arr, grp_off, grp_size, chunk, k, fid_bgn, fid_end,
                  total_len):
    """Concatenated contributed bases of frag ids [fid_bgn, fid_end)
    (decompress + bincode parse + delta apply + rc in C++).  None if
    unavailable or on parse failure."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(total_len, dtype=np.uint8)
    got = lib.pgr_frg_sub_bases(
        frg_arr, len(frg_arr), grp_off, grp_size, len(grp_off),
        chunk, k, fid_bgn, fid_end, out, total_len,
    )
    if got < 0:
        return None
    return out[:got].tobytes()
