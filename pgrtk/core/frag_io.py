"""FRG fragment-store backend: .frg / .sdx files (+ .mdb/.midx index).

File layout (reference: pgr-db/src/seq_db.rs:814-874, frag_file_io.rs):
  .frg — "FRG:0.5" + concatenated raw-deflate chunks, each a bincode
         Vec<Fragment> of up to chunk_size (256) fragments
  .sdx — "SDX:0.5" + bincode (chunk_size, Vec<(offset,size,frag_bases)>,
         Vec<CompactSeq>)
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

from . import bincodec, fragcomp, mdb
from .fasta import reverse_complement

FRG_MAGIC = b"FRG:0.5"
SDX_MAGIC = b"SDX:0.5"


def _frag_base_len(frag, k: int) -> int:
    kind = frag[0]
    if kind == "A":
        return frag[3] - k
    if kind == "I":
        return len(frag[1]) - k
    return len(frag[1])  # P / S


class FragFileStorage:
    """Random-access reader over a .frg/.sdx/.mdb/.midx prefix
    (reference: frag_file_io.rs:28-229)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(prefix + ".sdx", "rb") as f:
            data = f.read()
        assert data[:7] == SDX_MAGIC, "bad sdx magic"
        self.chunk_size, self.frag_addr_offsets, self.seqs = (
            bincodec.read_sdx_payload(data[7:])
        )
        with open(prefix + ".frg", "rb") as f:
            self.frg_data = f.read()
        assert self.frg_data[:7] == FRG_MAGIC, "bad frg magic"
        (
            self.spec,
            self.index_keys,
            self.index_starts,
            self.index_counts,
            self.index_sigs,
        ) = mdb.read_mdb_auto(prefix + ".mdb")
        self.seq_index: Dict[Tuple[str, Optional[str]], Tuple[int, int]] = {}
        self.seq_info: Dict[int, Tuple[str, Optional[str], int]] = {}
        for sid, slen, name, source in mdb.read_midx(prefix + ".midx"):
            self.seq_index[(name, source)] = (sid, slen)
            self.seq_info[sid] = (name, source, slen)
        self._group_cache: Dict[int, list] = {}
        self._seq_off_cache: Dict[int, "np.ndarray"] = {}
        # native reconstruction views (native/src/frg.cc): the frg blob
        # after the magic plus per-group (offset, size) arrays — sequence
        # fetches then decompress + bincode-parse + delta-apply in C++
        # (~3 us/fragment in Python); python paths stay as the fallback
        import numpy as np

        self._frg_arr = np.frombuffer(self.frg_data, dtype=np.uint8)[7:]
        self._grp_off = np.asarray(
            [o for o, _s, _b in self.frag_addr_offsets], dtype=np.int64
        )
        self._grp_size = np.asarray(
            [s for _o, s, _b in self.frag_addr_offsets], dtype=np.int64
        )
        self._native = None  # lazy: None = untried, False = unavailable

    def _native_api(self):
        if self._native is None:
            try:
                from ..native import api as native_api

                self._native = native_api if native_api.available() else False
            except Exception:  # pragma: no cover
                self._native = False
        return self._native or None

    # ------------------------------------------------------------------
    def _fetch_group(self, gid: int) -> list:
        cached = self._group_cache.get(gid)
        if cached is not None:
            return cached
        offset, size, _ = self.frag_addr_offsets[gid]
        raw = self.frg_data[7 + offset : 7 + offset + size]
        frags = bincodec.read_fragments(zlib.decompress(raw, -15))
        # ~512 groups x 256 frags ~ 64 MB: covers a whole multi-region
        # query working set (64 thrashed on 50-target region fetches)
        if len(self._group_cache) > 512:
            self._group_cache.clear()
        self._group_cache[gid] = frags
        return frags

    def _get_frag(self, fid: int):
        return self._fetch_group(fid // self.chunk_size)[fid % self.chunk_size]

    def _materialize(self, frag) -> bytes:
        """Fragment -> its stored bases (AlnSegments resolved, incl. overlap)."""
        if frag[0] != "A":
            return frag[1]
        _, base_id, reversed_, length, segs = frag
        base = self._get_frag(base_id)
        assert base[0] == "I", "AlnSegments base must be Internal"
        seq = fragcomp.reconstruct_seq_from_aln_segs(
            base[1], [_conv_seg(s) for s in segs]
        )
        assert len(seq) == length
        if reversed_:
            seq = reverse_complement(seq)
        return seq

    def _frag_bases(self, frag) -> bytes:
        """Bases contributed to the reconstructed sequence."""
        k = self.spec.k
        b = self._materialize(frag)
        if frag[0] in ("A", "I"):
            return b[k:]
        return b

    def get_seq_by_id(self, sid: int) -> bytes:
        source, name, _id, (start, n), slen = self.seqs[sid]
        nat = self._native_api()
        if nat is not None:
            out = nat.frg_sub_bases(
                self._frg_arr, self._grp_off, self._grp_size,
                self.chunk_size, self.spec.k, start, start + n, slen,
            )
            if out is not None:
                assert len(out) == slen, (len(out), slen)
                return out
        out = b"".join(
            self._frag_bases(self._get_frag(f)) for f in range(start, start + n)
        )
        assert len(out) == slen, (len(out), slen)
        return out

    def _frag_offsets(self, sid: int):
        """Cumulative reconstructed-base offsets of a sequence's
        fragments (n+1 entries), cached per sid: random sub-range access
        then touches ONLY the fragment groups overlapping the range
        (reference: frag_file_io.rs:182-228 random access by chunk
        ranges) instead of decoding the whole sequence per fetch."""
        import numpy as np

        cached = self._seq_off_cache.get(sid)
        if cached is not None:
            return cached
        _src, _name, _id, (start, n), _slen = self.seqs[sid]
        k = self.spec.k
        nat = self._native_api()
        lens = None
        if nat is not None:
            lens = nat.frg_base_lens(
                self._frg_arr, self._grp_off, self._grp_size,
                self.chunk_size, k, start, start + n,
            )
        offs = np.zeros(n + 1, dtype=np.int64)
        if lens is not None:
            np.cumsum(lens, out=offs[1:])
        else:
            for j, fid in enumerate(range(start, start + n)):
                offs[j + 1] = offs[j] + _frag_base_len(self._get_frag(fid), k)
        if len(self._seq_off_cache) > 4096:
            self._seq_off_cache.clear()
        self._seq_off_cache[sid] = offs
        return offs

    def get_sub_seq_by_id(self, sid: int, bgn: int, end: int) -> bytes:
        import numpy as np

        _src, _name, _id, (start, n), _slen = self.seqs[sid]
        offs = self._frag_offsets(sid)
        if n == 0 or end <= bgn:
            return b""
        # fragments overlapping [bgn, end): binary search the offsets
        first = max(0, int(np.searchsorted(offs, bgn, side="right")) - 1)
        last = max(
            first, int(np.searchsorted(offs, max(end - 1, bgn), side="right")) - 1
        )
        last = min(last, n - 1)
        # native reconstruction amortizes its per-call group inflate
        # over many fragments; SMALL fetches (server ROI loops hitting
        # the same groups repeatedly) stay on the Python path whose
        # group cache makes repeat hits free
        nat = (
            self._native_api() if (last + 1 - first) > 16 else None
        )
        rec = None
        if nat is not None:
            rec = nat.frg_sub_bases(
                self._frg_arr, self._grp_off, self._grp_size,
                self.chunk_size, self.spec.k,
                start + first, start + last + 1,
                int(offs[last + 1] - offs[first]),
            )
        if rec is None:
            rec = b"".join(
                self._frag_bases(self._get_frag(start + j))
                for j in range(first, last + 1)
            )
        offset = bgn - int(offs[first])
        return rec[offset : offset + (end - bgn)]


def _conv_seg(s):
    if s[0] == "F":
        return (fragcomp.FULL_MATCH,)
    if s[0] == "M":
        return (fragcomp.MATCH, s[1], s[2])
    return (fragcomp.INSERTION, s[1])


def _unconv_seg(s):
    if s[0] == fragcomp.FULL_MATCH:
        return ("F",)
    if s[0] == fragcomp.MATCH:
        return ("M", s[1], s[2])
    return ("I", s[1])


# ---------------------------------------------------------------------------
# writer (reference: seq_db.rs:814-874)
# ---------------------------------------------------------------------------
def write_frag_files(db, prefix: str, chunk_size: int = 256) -> None:
    """Write .frg/.sdx from a CompactSeqDB (pgrtk.core.seqdb), delta-
    compressing repeat fragments against the first fragment with the same
    shimmer-pair key via the native O(nD) aligner
    (reference: seq_db.rs:249-315)."""
    from ..native import api as native

    k = db.spec.k
    use_native = native.available()

    # map frag_id -> (key, orientation) for internal frags
    frag_key: Dict[int, Tuple[Tuple[int, int], int]] = {}
    first_frag_of_key: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for key, sigs in db.frag_map.items():
        for fid, _sid, _b, _e, ori in sigs:
            frag_key[fid] = (key, ori)
        if sigs:
            first_frag_of_key[key] = (sigs[0][0], sigs[0][4])

    out_frags: List[tuple] = []
    for fid, (kind, bases) in enumerate(db.frags):
        from .seqdb import INTERNAL, PREFIX

        if kind == PREFIX:
            out_frags.append(("P", bases))
        elif kind == INTERNAL:
            entry = frag_key.get(fid)
            compressed = None
            if use_native and entry is not None:
                key, ori = entry
                base_fid, base_ori = first_frag_of_key.get(key, (fid, ori))
                if base_fid != fid and len(bases) > 128 + k:
                    base_kind, base_bases = db.frags[base_fid]
                    if base_kind == INTERNAL and len(base_bases) > 0:
                        if ori != base_ori:
                            frg = reverse_complement(bases)
                            rc = True
                        else:
                            frg = bases
                            rc = False
                        m = native.match_reads(
                            base_bases, frg, get_delta=True, tol=0.1, bandwidth=32
                        )
                        if m is not None:
                            segs = fragcomp.deltas_to_aln_segs(
                                m["deltas"], m["end0"], m["end1"], base_bases, frg
                            )
                            compressed = (
                                "A",
                                base_fid,
                                rc,
                                len(frg),
                                [_unconv_seg(s) for s in segs],
                            )
            out_frags.append(compressed if compressed else ("I", bases))
        else:
            out_frags.append(("S", bases))

    chunks = [
        out_frags[i : i + chunk_size] for i in range(0, len(out_frags), chunk_size)
    ]

    def _deflate(chunk):
        comp = zlib.compressobj(6, zlib.DEFLATED, -15)
        return comp.compress(bincodec.write_fragments(chunk)) + comp.flush()

    # deflate dominates the write (~97% measured) and releases the GIL:
    # compress chunks on a thread pool with a bounded in-flight window
    # (memory stays O(window), not O(file)) and write in order (the
    # reference rayon-parallelizes the same loop, seq_db.rs:814-874)
    import os as _os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    addrs = []
    offset = 0
    window = 4 * max(1, _os.cpu_count() or 1)
    with ThreadPoolExecutor() as ex, open(prefix + ".frg", "wb") as f:
        f.write(FRG_MAGIC)
        pending = deque()
        it = iter(chunks)
        for chunk in it:
            pending.append((chunk, ex.submit(_deflate, chunk)))
            if len(pending) < window:
                continue
            chunk0, fut = pending.popleft()
            blob = fut.result()
            total_bases = sum(_frag_base_len(fr, k) for fr in chunk0)
            addrs.append((offset, len(blob), total_bases))
            offset += len(blob)
            f.write(blob)
        while pending:
            chunk0, fut = pending.popleft()
            blob = fut.result()
            total_bases = sum(_frag_base_len(fr, k) for fr in chunk0)
            addrs.append((offset, len(blob), total_bases))
            offset += len(blob)
            f.write(blob)

    with open(prefix + ".sdx", "wb") as f:
        f.write(SDX_MAGIC)
        seqs = [
            (s.source, s.name, s.id, s.seq_frag_range, s.len) for s in db.seqs
        ]
        f.write(bincodec.write_sdx_payload(chunk_size, addrs, seqs))
