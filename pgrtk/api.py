"""SeqIndexDB — the unified pangenome database facade.

API surface mirrors the reference facade (pgr-db/src/ext.rs:48-974 and the
PyO3 bindings in pgr-tk/src/lib.rs) so reference workflows port directly:
backends FRG / FASTX / MEMORY (AGC-equivalent archive backend: see
pgrtk.core.pga), loaders, query dispatch, sequence fetch, principal
bundles, GFA writers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

import logging
import time

from .core import frag_io, mdb, query as query_mod
from .core.seqdb import CompactSeqDB
from .core.spec import ShmmrSpec


def consensus_bundle_order_direction(
    bundle_orders: Dict[int, List[float]],
    bundle_dirs: Dict[int, List[int]],
    n_bundles: int,
) -> List[Tuple[int, int, int]]:
    """The bundle order/direction consensus vote (ext.rs:601-625),
    reference-exact, as a pure function for adversarial-vector testing.

    Returns sorted [(mean_ord, bid, direction)].  Reference quirks
    preserved bit-for-bit:

      * the order mean is accumulated in f32 in input order
        (`let sum: f32 = orders.iter().sum()`), divided in f32, then
        TRUNCATED (`as usize`) — above 2^24 the f32 sum rounds, which
        can shift the truncated mean vs a f64 sum;
      * the direction rule is `dir_sum < (len >> 1)` -> 0 else 1 — NOT
        a majority vote: an exact half AND one-below-half-of-odd both
        yield direction 1 (e.g. 2 reverse of 5 votes);
      * bundles never visited by any sequence get order usize::MAX and
        direction 0, sorting last (stable by bid via tuple sort).
    """
    out: List[Tuple[int, int, int]] = []
    for bid in range(n_bundles):
        if bid in bundle_orders:
            orders = bundle_orders[bid]
            s = np.float32(0.0)
            for o in orders:
                s = np.float32(s + np.float32(o))
            mean_ord = int(np.float32(s / np.float32(len(orders))))
            dirs = bundle_dirs[bid]
            direction = 0 if sum(dirs) < (len(dirs) >> 1) else 1
            out.append((mean_ord, bid, direction))
        else:
            out.append((2**64 - 1, bid, 0))  # usize::MAX (ext.rs:609)
    out.sort()
    return out

log = logging.getLogger("pgrtk")


class Backend:
    UNKNOWN = "UNKNOWN"
    MEMORY = "MEMORY"
    FASTX = "FASTX"
    FRG = "FRG"
    AGC = "AGC"


class SeqIndexDB:
    def __init__(self):
        self.seq_db: Optional[CompactSeqDB] = None
        self.frg_db: Optional[frag_io.FragFileStorage] = None
        self.agc_db = None
        self.shmmr_spec: Optional[ShmmrSpec] = None
        self.seq_index: Optional[Dict[Tuple[str, Optional[str]], Tuple[int, int]]] = None
        self.seq_info: Optional[Dict[int, Tuple[str, Optional[str], int]]] = None
        self.backend = Backend.UNKNOWN

    # ------------------------------------------------------------------
    # loaders
    # ------------------------------------------------------------------
    def _invalidate_caches(self):
        self._pb_cache = None
        self._probe_cache = None
        self._smps_cache = None

    def _rebuild_seq_maps_from_seq_db(self):
        self._invalidate_caches()
        seq_index = {}
        seq_info = {}
        for s in self.seq_db.seqs:
            seq_index[(s.name, s.source)] = (s.id, s.len)
            seq_info[s.id] = (s.name, s.source, s.len)
        self.seq_index = seq_index
        self.seq_info = seq_info

    def load_from_fastx(
        self, filepath: str, w=80, k=56, r=4, min_span=64
    ) -> None:
        """(reference: ext.rs:152-181; sketch=false there)"""
        spec = ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=False)
        sdb = CompactSeqDB(spec)
        t0 = time.monotonic()
        sdb.load_from_fastx(filepath)
        self.seq_db = sdb
        self.shmmr_spec = spec
        self.backend = Backend.FASTX
        self._rebuild_seq_maps_from_seq_db()
        log.info(
            "loaded fastx %s: %d seqs, %d shimmer-pair keys (%.2f s)",
            filepath, len(self.seq_info), len(sdb.frag_map),
            time.monotonic() - t0,
        )

    def append_from_fastx(self, filepath: str) -> None:
        assert self.backend == Backend.FASTX, (
            "Only DB created with load_from_fastx() can append"
        )
        self.seq_db.load_from_fastx(filepath)
        self._rebuild_seq_maps_from_seq_db()

    def load_from_seq_list(
        self,
        seq_list: List[Tuple[str, bytes]],
        source: Optional[str] = "Memory",
        w=80,
        k=56,
        r=4,
        min_span=8,
    ) -> None:
        """(reference: ext.rs:212-249; defaults from the PyO3 signature
        pgr-tk/src/lib.rs:196 — note min_span=8 here vs 64 for
        load_from_fastx, a reference asymmetry)"""
        spec = ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=False)
        sdb = CompactSeqDB(spec)
        sdb.load_seqs([(source, name, seq) for name, seq in seq_list])
        self.seq_db = sdb
        self.shmmr_spec = spec
        self.backend = Backend.MEMORY
        self._rebuild_seq_maps_from_seq_db()

    def load_from_frg_index(self, prefix: str) -> None:
        """(reference: ext.rs:131-150)"""
        t0 = time.monotonic()
        self._invalidate_caches()
        frg = frag_io.FragFileStorage(prefix)
        self.frg_db = frg
        self.shmmr_spec = frg.spec
        self.backend = Backend.FRG
        self.seq_index = dict(frg.seq_index)
        self.seq_info = dict(frg.seq_info)
        log.info(
            "loaded frg index %s: %d seqs, %d keys (%.2f s)",
            prefix, len(self.seq_info), len(frg.index_keys),
            time.monotonic() - t0,
        )

    def load_from_agc_index(self, prefix: str) -> None:
        """AGC-equivalent archive backend (reference: ext.rs:87-129)."""
        from .core.pga import PgaSeqDB

        t0 = time.monotonic()
        self._invalidate_caches()
        agc = PgaSeqDB(prefix)
        self.agc_db = agc
        self.shmmr_spec = agc.spec
        self.backend = Backend.AGC
        self.seq_index = dict(agc.seq_index)
        self.seq_info = dict(agc.seq_info)
        log.info(
            "loaded archive index %s: %d seqs, %d keys (%.2f s)",
            prefix, len(self.seq_info), len(agc.index_keys),
            time.monotonic() - t0,
        )

    def write_frag_and_index_files(self, file_prefix: str) -> None:
        """(reference: ext.rs:201-210)"""
        if self.seq_db is not None:
            t0 = time.monotonic()
            frag_io.write_frag_files(self.seq_db, file_prefix)
            self.seq_db.write_mdb_midx(file_prefix)
            log.info(
                "wrote frg+mdb index %s (%.2f s)",
                file_prefix, time.monotonic() - t0,
            )

    def write_midx_to_text_file(self, filepath: str) -> None:
        mdb.write_midx(
            (
                (sid, info[2], info[0], info[1])
                for sid, info in sorted(self.seq_info.items())
            ),
            filepath,
        )

    # ------------------------------------------------------------------
    # index lookup
    # ------------------------------------------------------------------
    def _lookup_fn(self):
        if self.backend in (Backend.MEMORY, Backend.FASTX):
            frag_map = self.seq_db.frag_map

            def lookup(s0, s1):
                return frag_map.get((s0, s1), [])

            return lookup
        if self.backend == Backend.FRG:
            return self._columnar_lookup(self.frg_db)
        if self.backend == Backend.AGC:
            return self._columnar_lookup(self.agc_db)
        raise RuntimeError("database type is not determined")

    @staticmethod
    def _columnar_lookup(db):
        keys = db.index_keys
        starts = db.index_starts
        counts = db.index_counts
        sigs = db.index_sigs
        from .utils.u64pair import cols_ckeys, pair_ckeys

        # ONE searchsorted over combined lexicographic keys replaces the
        # three-step per-key binary search (ordering trick documented in
        # utils/u64pair.py)
        ckeys = pair_ckeys(keys)
        n_keys = len(ckeys)

        def _block(j):
            s, c = int(starts[j]), int(counts[j])
            return sigs[s : s + c].tolist()

        def lookup(s0, s1):
            q = np.empty((1, 2), dtype=np.uint64)
            q[0, 0] = s0
            q[0, 1] = s1
            cq = pair_ckeys(q)[0]
            j = int(np.searchsorted(ckeys, cq, side="left"))
            if j >= n_keys or ckeys[j] != cq:
                return []
            return _block(j)

        def lookup_many(s0_arr, s1_arr):
            """Vectorized lookup of n (hash0, hash1) keys at once:
            returns a list of n signature lists."""
            n = len(s0_arr)
            cq = cols_ckeys(s0_arr, s1_arr)
            js = np.searchsorted(ckeys, cq, side="left")
            js_c = np.minimum(js, n_keys - 1) if n_keys else js
            found = (
                (js < n_keys) & (ckeys[js_c] == cq) if n_keys
                else np.zeros(n, dtype=bool)
            )
            out = []
            fl = found.tolist()
            jl = js.tolist()
            for i in range(n):
                out.append(_block(jl[i]) if fl[i] else [])
            return out

        lookup.many = lookup_many
        return lookup

    def get_shmmr_spec(self):
        s = self.shmmr_spec
        return None if s is None else (s.w, s.k, s.r, s.min_span, s.sketch)

    def get_seq_index(self):
        """(ctg_name, source) -> (id, len) (reference: pgr-tk lib.rs:213)."""
        return None if not self.seq_index else dict(self.seq_index)

    def get_seq_info(self):
        """id -> (ctg_name, source, len) (reference: pgr-tk lib.rs:221)."""
        return None if not self.seq_info else dict(self.seq_info)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def query_fragment(self, seq: bytes):
        """Raw anchors (reference: pgr-tk/src/lib.rs:249-290)."""
        return query_mod.raw_query_fragment(self._lookup_fn(), seq, self.shmmr_spec)

    def get_match_positions_with_fragment(self, seq: bytes):
        return query_mod.get_match_positions_with_fragment(
            self._lookup_fn(), seq, self.shmmr_spec
        )

    def query_fragment_to_hps(
        self,
        seq: bytes,
        penalty: float,
        max_count: Optional[int] = None,
        max_count_query: Optional[int] = None,
        max_count_target: Optional[int] = None,
        max_aln_span: Optional[int] = None,
        max_gap: Optional[int] = None,
        oriented: bool = False,
    ):
        store = (
            self.frg_db if self.backend == Backend.FRG
            else self.agc_db if self.backend == Backend.AGC
            else None
        )
        if store is not None:
            # columnar fast path: zero per-signature Python (bit-identical
            # output; core/query.py:query_fragment_to_hps_columnar)
            return query_mod.query_fragment_to_hps_columnar(
                store, seq, self.shmmr_spec, penalty,
                max_count, max_count_query, max_count_target,
                max_aln_span, max_gap, oriented,
            )
        raw = query_mod.raw_query_fragment(self._lookup_fn(), seq, self.shmmr_spec)
        return query_mod.query_fragment_to_hps(
            raw,
            penalty,
            max_count,
            max_count_query,
            max_count_target,
            max_aln_span,
            max_gap,
            oriented,
        )

    # mmap variant is the same lookup path here (no separate in-memory map)
    query_fragment_to_hps_from_mmap_file = query_fragment_to_hps

    # ------------------------------------------------------------------
    # sequence fetch (reference: ext.rs:344-489)
    # ------------------------------------------------------------------
    def _store(self):
        if self.backend in (Backend.MEMORY, Backend.FASTX):
            return self.seq_db
        if self.backend == Backend.FRG:
            return self.frg_db
        if self.backend == Backend.AGC:
            return self.agc_db
        raise RuntimeError("database type is not determined")

    def get_seq(self, sample_name: str, ctg_name: str) -> bytes:
        sid, _ = self.seq_index[(ctg_name, sample_name)]
        return self._store().get_seq_by_id(sid)

    def get_sub_seq(
        self, sample_name: str, ctg_name: str, bgn: int, end: int
    ) -> bytes:
        sid, _ = self.seq_index[(ctg_name, sample_name)]
        return self._store().get_sub_seq_by_id(sid, bgn, end)

    def get_seq_by_id(self, sid: int) -> bytes:
        return self._store().get_seq_by_id(sid)

    def get_sub_seq_by_id(self, sid: int, bgn: int, end: int) -> bytes:
        return self._store().get_sub_seq_by_id(sid, bgn, end)

    # ------------------------------------------------------------------
    # index views (reference: pgr-tk/src/lib.rs:636-790)
    # ------------------------------------------------------------------
    def get_shmmr_map_internal(self):
        if self.backend in (Backend.MEMORY, Backend.FASTX):
            return self.seq_db.frag_map
        return None

    def get_shmmr_map(self):
        m = self.get_shmmr_map_internal()
        if m is not None:
            return m
        # columnar backends: materialize
        db = self.frg_db if self.backend == Backend.FRG else self.agc_db
        out = {}
        for i in range(db.index_keys.shape[0]):
            s, c = int(db.index_starts[i]), int(db.index_counts[i])
            out[(int(db.index_keys[i, 0]), int(db.index_keys[i, 1]))] = [
                tuple(int(x) for x in rec) for rec in db.index_sigs[s : s + c]
            ]
        return out

    def get_shmmr_pair_count(self, shmmr_pair):
        """Postings count for ONE shimmer pair, 0 if absent
        (reference: pgr-tk/src/lib.rs:635-648 — per-pair lookup, not a
        whole-table aggregate)."""
        return len(self.get_shmmr_map().get(tuple(shmmr_pair), ()))

    def get_shmmr_pair_list(self):
        out = []
        for (h0, h1), sigs in self.get_shmmr_map().items():
            for _fid, sid, b, e, ori in sigs:
                out.append((h0, h1, sid, b, e, ori))
        return out

    # ------------------------------------------------------------------
    # MAP graph / principal bundles (reference: ext.rs:491-650 and the
    # PyO3 layer pgr-tk/src/lib.rs:894-1315)
    # ------------------------------------------------------------------
    def get_smp_adj_list(self, min_count: int, keeps=None):
        from .graph import bundles as gb

        return gb.frag_map_to_adj_list(self.get_shmmr_map(), min_count, keeps)

    def sort_adj_list_by_weighted_dfs(self, adj_list, start):
        from .graph import bundles as gb

        return gb.sort_adj_list_by_weighted_dfs(
            self.get_shmmr_map(), adj_list, tuple(start)
        )

    def _principal_cached(self, min_count, path_len_cutoff, keeps):
        """Principal-bundle decomposition, cached per parameter set (the
        reference's pyclass caches bundles the same way, lib.rs:58-64):
        pgr-pbundle-decomp computes the identical decomposition for the
        BED emit and the principal GFA — one run serves both."""
        key = (
            min_count, path_len_cutoff,
            tuple(sorted(keeps)) if keeps is not None else None,
        )
        cache = getattr(self, "_pb_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1]
        from .graph import bundles as gb

        frag_map = self.get_shmmr_map()
        res = gb.principal_bundles_from_frag_map(
            frag_map, min_count, keeps, path_len_cutoff
        )
        self._pb_cache = (key, res)
        return res

    def get_principal_bundles(
        self, min_count: int, path_len_cutoff: int, keeps=None
    ):
        pb, _ = self._principal_cached(min_count, path_len_cutoff, keeps)
        return pb

    @staticmethod
    def _get_vertex_map_from_principal_bundles(pb):
        out = {}
        for bundle_id, path in enumerate(pb):
            for p, v in enumerate(path):
                out[(v[0], v[1])] = (bundle_id, v[2], p)
        return out

    def get_smps(self, seq: bytes):
        """Canonical shimmer pairs of a sequence (query convention:
        strict `<`, tie -> 1; reference: ext.rs:533-549)."""
        from .core import query as query_mod
        from .core import sketch as sketch_mod

        mers = sketch_mod.sequence_to_shmmrs(0, seq, self.shmmr_spec, False)
        return query_mod.pair_shmmrs_canonical(mers)

    def get_smps_by_id(self, sid: int):
        """Shimmer pairs of an INDEXED sequence, reconstructed from the
        fragment index itself — no sequence fetch, no re-sketch.

        The reference re-scans every sequence for the projection
        (ext.rs:564-650 fetches + get_smps), paying the sketch twice per
        decomposition.  But the builder's fragment signatures already
        store exactly the smps fields: (bgn, end) = (s0.pos()+1,
        s1.pos()+1) (seq_db.rs:396-397), canonical hash order, and the
        SAME pair stream (both sides pair consecutive min_span-kept
        mers).  The single divergence is the hash-tie orientation — the
        builder keeps 0 on ties (`s0 <= s1`, seq_db.rs:391) while
        get_smps uses strict `<` (tie -> 1, ext.rs:543-547) — so ties
        are flipped to 1 here.  Output is bit-identical to
        get_smps(self.get_seq_by_id(sid)); pinned by
        tests/test_bundles_and_ec.py."""
        return self._sid_smps_from_index().get(sid, [])

    def _sid_smps_from_index(self):
        """dict sid -> [(h0, h1, p0, p1, ori)] in position order, from
        one pass over the fragment index (cached; invalidated with the
        other caches on every load/append)."""
        cache = getattr(self, "_smps_cache", None)
        if cache is not None:
            return cache
        import numpy as np

        per_sid: Dict[int, list] = {sid: [] for sid in self.seq_info}
        m = self.get_shmmr_map_internal()
        if m is not None:
            rows = []
            for (h0, h1), lst in m.items():
                for frg_id, s, bgn, end, ori in lst:
                    rows.append((s, frg_id, h0, h1, bgn, end, ori))
            rows.sort()
            for s, _f, h0, h1, bgn, end, ori in rows:
                per_sid.setdefault(s, []).append(
                    (h0, h1, bgn, end, 1 if h0 == h1 else ori)
                )
        else:
            db = self.frg_db if self.backend == Backend.FRG else self.agc_db
            counts = np.asarray(db.index_counts, dtype=np.int64)
            n = int(counts.sum())
            h0 = np.repeat(np.asarray(db.index_keys[:, 0]), counts)
            h1 = np.repeat(np.asarray(db.index_keys[:, 1]), counts)
            frg = np.empty(n, dtype=np.int64)
            sidc = np.empty(n, dtype=np.int64)
            bgn = np.empty(n, dtype=np.uint32)
            end = np.empty(n, dtype=np.uint32)
            ori = np.empty(n, dtype=np.uint8)
            w = 0
            sigs = db.index_sigs
            starts = np.asarray(db.index_starts, dtype=np.int64)
            for i in range(counts.shape[0]):
                c = int(counts[i])
                rec = sigs[int(starts[i]): int(starts[i]) + c]
                frg[w: w + c] = rec["frg_id"]
                sidc[w: w + c] = rec["seq_id"]
                bgn[w: w + c] = rec["bgn"]
                end[w: w + c] = rec["end"]
                ori[w: w + c] = rec["orientation"]
                w += c
            ori = np.where(h0 == h1, np.uint8(1), ori)
            order = np.lexsort((frg, sidc))
            sid_sorted = sidc[order]
            cut = np.flatnonzero(np.diff(sid_sorted)) + 1
            groups = np.split(order, cut)
            for g in groups:
                if len(g) == 0:
                    continue
                s = int(sid_sorted[0] if len(cut) == 0 else sidc[g[0]])
                per_sid[s] = list(
                    zip(
                        (int(v) for v in h0[g]),
                        (int(v) for v in h1[g]),
                        (int(v) for v in bgn[g]),
                        (int(v) for v in end[g]),
                        (int(v) for v in ori[g]),
                    )
                )
        self._smps_cache = per_sid
        return per_sid

    def get_principal_bundles_with_id(
        self, min_count: int, path_len_cutoff: int, keeps=None
    ):
        """Reordered bundles + vertex map (reference: ext.rs:552-650).
        Returns ([(bid, mean_order, [(h0, h1, dir)])], vertex_map)."""
        pb = self.get_principal_bundles(min_count, path_len_cutoff, keeps)
        # one sketch serves both stages: the projection's smps come from
        # the fragment index (get_smps_by_id) instead of the reference's
        # fetch + re-sketch of every sequence (ext.rs:564-650)
        smps_map = self._sid_smps_from_index()
        seqid_smps = [
            (sid, smps_map.get(sid, [])) for sid in sorted(self.seq_info)
        ]
        pbid, _sid_smps, vertex_map = self._principal_bundle_projection(
            pb, None, return_vertex_map=True, seqid_smps=seqid_smps
        )
        return pbid, vertex_map

    def _principal_bundle_projection(
        self, pb, seqid_seq_list, return_vertex_map: bool = False,
        seqid_smps=None,
    ):
        """(reference: pgr-tk/src/lib.rs:1147-1285).  Callers projecting
        the db's OWN sequences pass seqid_smps from the index
        (get_smps_by_id: shared sketch); external sequences go through
        seqid_seq_list + get_smps."""
        vertex_map = self._get_vertex_map_from_principal_bundles(pb)
        if seqid_smps is None:
            seqid_smps = [
                (sid, self.get_smps(seq)) for sid, seq in seqid_seq_list
            ]

        bundle_dirs: Dict[int, List[int]] = {}
        bundle_orders: Dict[int, List[float]] = {}
        for _sid, smps in seqid_smps:
            visited = set()
            for order, v in enumerate(smps):
                bid = vertex_map.get((v[0], v[1]))
                if bid is None:
                    continue
                if bid[0] not in visited:
                    bundle_orders.setdefault(bid[0], []).append(float(order))
                    visited.add(bid[0])
                bundle_dirs.setdefault(bid[0], []).append(
                    0 if bid[1] == v[4] else 1
                )

        mean_order_direction = consensus_bundle_order_direction(
            bundle_orders, bundle_dirs, len(pb)
        )

        principal_bundles = []
        for ord_, bid, direction in mean_order_direction:
            if direction == 1:
                rpb = [(v[0], v[1], 1 - v[2]) for v in reversed(pb[bid])]
                for p, v in enumerate(rpb):
                    vertex_map[(v[0], v[1])] = (bid, v[2], p)
                bundle = rpb
            else:
                bundle = list(pb[bid])
            principal_bundles.append((bid, ord_, bundle))

        sid_smps = [
            (
                sid,
                [(tuple(v), vertex_map.get((v[0], v[1]))) for v in smps],
            )
            for sid, smps in seqid_smps
        ]
        if return_vertex_map:
            return principal_bundles, sid_smps, vertex_map
        return principal_bundles, sid_smps

    def get_principal_bundle_decomposition(
        self, min_count: int, path_len_cutoff: int, keeps=None
    ):
        pb = self.get_principal_bundles(min_count, path_len_cutoff, keeps)
        smps_map = self._sid_smps_from_index()
        seqid_smps = [
            (sid, smps_map.get(sid, [])) for sid in sorted(self.seq_info)
        ]
        return self._principal_bundle_projection(
            pb, None, seqid_smps=seqid_smps
        )

    def get_principal_bundle_projection(
        self, min_count: int, path_len_cutoff: int, sequence, keeps=None
    ):
        pb = self.get_principal_bundles(min_count, path_len_cutoff, keeps)
        return self._principal_bundle_projection(pb, sequence)

    def generate_mapg_gfa(
        self, min_count: int, filepath: str, method: str = "from_fragmap",
        keeps=None
    ):
        from .graph import bundles as gb
        from .graph import gfa as gfa_mod

        frag_map = self.get_shmmr_map()
        if method == "from_fragmap":
            adj_list = gb.frag_map_to_adj_list(frag_map, min_count, keeps)
        else:
            keep_set = set(keeps) if keeps is not None else None
            adj_list = []
            for sid in sorted(self.seq_info):
                seq = self.get_seq_by_id(sid)
                mc = 0 if (keep_set and sid in keep_set) else min_count
                adj_list.extend(
                    gb.generate_smp_adj_list_for_seq(
                        seq, sid, frag_map, self.shmmr_spec, mc
                    )
                )
        gfa_mod.write_mapg_gfa(frag_map, adj_list, self.shmmr_spec.k, filepath)

    def write_mapg_idx(self, filepath: str):
        from .graph import gfa as gfa_mod

        gfa_mod.write_mapg_idx(
            self.shmmr_spec, self.seq_info, self.get_shmmr_map(), filepath
        )

    def generate_principal_mapg_gfa(
        self, min_count: int, path_len_cutoff: int, filepath: str, keeps=None
    ):
        from .graph import bundles as gb
        from .graph import gfa as gfa_mod

        frag_map = self.get_shmmr_map()
        pb, filtered_adj = self._principal_cached(
            min_count, path_len_cutoff, keeps
        )
        if not pb and not filtered_adj:
            # skip the file only when there is no graph at all; when
            # path_len_cutoff filtered every path, still write the
            # (header-only) GFA so downstream tooling finds the file
            if not gb.frag_map_to_adj_list(frag_map, min_count, keeps):
                return
        vertex_map = self._get_vertex_map_from_principal_bundles(pb)
        gfa_mod.write_mapg_gfa(
            frag_map,
            filtered_adj,
            self.shmmr_spec.k,
            filepath,
            vertex_to_bundle=vertex_map,
        )

    # ------------------------------------------------------------------
    # position mapping (reference: pgr-tk/src/lib.rs:471-620)
    # ------------------------------------------------------------------
    def map_positions_in_seq(
        self,
        positions,
        seq: bytes,
        penalty: float,
        max_count=None,
        max_count_query=None,
        max_count_target=None,
        max_aln_span=None,
        max_gap=None,
        orientated: bool = False,
    ):
        from .core import query as query_mod
        from .core.fasta import reverse_complement
        from .native import api as native

        k = self.shmmr_spec.k
        raw = query_mod.raw_query_fragment(
            self._lookup_fn(), seq, self.shmmr_spec
        )
        all_alns = query_mod.query_fragment_to_hps(
            raw,
            penalty,
            max_count,
            max_count_query,
            max_count_target,
            max_aln_span,
            max_gap,
            orientated,
        )
        pos2hits: Dict[int, list] = {}
        for t_id, alns in all_alns:
            for score, hits in alns:
                hits = sorted(hits)
                for pos in positions:
                    left = None
                    right = None
                    for v, w in hits:
                        if v[0] < pos:
                            left = (v, w)
                        if right is None and pos < v[1]:
                            right = (v, w)
                    if left is not None and right is not None:
                        pos2hits.setdefault(pos, []).append(
                            (t_id, score, left, right)
                        )

        out = []
        for pos, hits in pos2hits.items():
            for seq_id, _score, left, right in hits:
                ctg, src, t_len = self.seq_info[seq_id]
                same_orientation = left[0][2] == left[1][2]
                qb = left[0][0]
                qe = right[0][1]
                if same_orientation:
                    tb = left[1][0]
                    te = right[1][1]
                else:
                    tb = right[1][0] - k
                    te = left[1][1] - k
                if tb >= te:
                    continue
                t_seq = self.get_sub_seq(src, ctg, tb, te)
                if not same_orientation:
                    t_seq = reverse_complement(t_seq)
                q_seq = bytes(seq[qb:qe])
                ovlp = native.match_reads(
                    q_seq, t_seq, True, 0.10, 1, 1, 1000
                )
                if ovlp is None:
                    continue
                dpos = pos - qb
                delta = list(ovlp["deltas"]) + [(0, 0, 0)]
                dref = None
                for dx, dy, _dk in delta:
                    if dx <= dpos:
                        dref = (dx, dy)
                        break
                orientation = 0 if same_orientation else 1
                dpos = dpos + dref[1] - dref[0]
                if same_orientation:
                    tpos = tb + dpos
                    tb2, te2 = tb, te
                else:
                    tb2, te2 = t_len - te, t_len - tb
                    tpos = t_len - (te - dpos)
                out.append((pos, (seq_id, tpos, orientation), (qb, qe), (tb2, te2)))
        return out

    def shmmr_sparse_aln_consensus(self, sids, min_cov: int):
        """Consensus from DB sequences (reference: pgr-tk/src/lib.rs:1387-1403)."""
        from .core import ec

        assert self.backend in (Backend.MEMORY, Backend.FASTX), (
            "shmmr_sparse_aln_consensus needs an in-memory backend"
        )
        return ec.shmmr_sparse_aln_consensus_with_sdb(
            list(sids), self.seq_db, min_cov
        )

    def get_shmmr_pair_source_count(self, shmmr_pair, max_unique_count):
        """Hit counts of ONE shimmer pair partitioned by source file:
        [(source, count)] with counts >= max_unique_count filtered out
        (strict <, reference: pgr-tk/src/lib.rs:668-719; a None source
        prints as the empty string there, replicated)."""
        sigs = self.get_shmmr_map().get(tuple(shmmr_pair))
        if sigs is None:
            return []
        count = {}
        for _fid, sid, _b, _e, _o in sigs:
            info = self.seq_info.get(sid)
            source = (info[1] if info and info[1] is not None else "")
            count[source] = count.get(source, 0) + 1
        return [
            (k, v)
            for k, v in count.items()
            if max_unique_count is None or v < max_unique_count
        ]


def get_principal_bundle_decomposition(vertex_to_bundle_id_direction_pos, seq_db):
    """Free-function decomposition against a precomputed vertex map
    (reference: ext.rs:976-1015)."""
    out = []
    # shared sketch: the db's own sequences project from index-derived
    # smps (get_smps_by_id) — no fetch, no re-sketch; a foreign seq_db
    # object without that method falls back to the reference's re-scan
    from_index = getattr(seq_db, "get_smps_by_id", None)
    for sid in sorted(seq_db.seq_info):
        if from_index is not None:
            smps = from_index(sid)
        else:
            smps = seq_db.get_smps(seq_db.get_seq_by_id(sid))
        out.append(
            (
                sid,
                [
                    (tuple(v), vertex_to_bundle_id_direction_pos.get((v[0], v[1])))
                    for v in smps
                ],
            )
        )
    return out
