"""Asynchronous archive input pipeline.

The reference decodes AGC archives on a dedicated reader thread pool in
1024-contig chunks with thread-local archive handles, keeping the
(CPU-bound) sketching workers fed (pgr-db/src/agc_io.rs:201-333).  This
is the equivalent for the index build here: a ThreadPoolExecutor whose
workers each hold their OWN archive handle (the native readers are not
shared across threads, exactly like the reference's thread_local
AGCFile), decoding a bounded window of chunks ahead of the consumer.

Memory is bounded by prefetch * chunk_contigs decoded contigs; order is
preserved (chunks yield in submission order).
"""
from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

log = logging.getLogger("pgrtk")

Record = Tuple[Optional[str], str, bytes]  # (sample/source, ctg, bases)


def stream_archive(
    path: str,
    chunk_contigs: int = 1024,
    nthreads: int = 4,
    prefetch: int = 4,
) -> Iterator[List[Record]]:
    """Yield (sample, ctg, seq) records from a .pga/.agc archive in
    chunks, decoded ahead of the consumer by a reader pool."""
    from .agc import open_archive

    head = open_archive(path)
    jobs: List[List[Tuple[str, str]]] = []
    cur: List[Tuple[str, str]] = []
    for sample in head.list_samples():
        for ctg, _ln in head.list_ctgs(sample):
            cur.append((sample, ctg))
            if len(cur) >= chunk_contigs:
                jobs.append(cur)
                cur = []
    if cur:
        jobs.append(cur)

    if len(jobs) <= 1 or nthreads <= 1:
        # small archive: decode synchronously on the already-open handle
        for job in jobs:
            yield [(s, c, head.get_seq(s, c)) for s, c in job]
        return

    local = threading.local()

    def decode(job: List[Tuple[str, str]]) -> List[Record]:
        handle = getattr(local, "archive", None)
        if handle is None:
            # one handle per reader thread (agc_io.rs:218 thread_local)
            handle = open_archive(path)
            local.archive = handle
        return [(s, c, handle.get_seq(s, c)) for s, c in job]

    log.info(
        "archive pipeline: %d chunks x %d contigs, %d readers, "
        "prefetch %d", len(jobs), chunk_contigs, nthreads, prefetch,
    )
    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        inflight = []
        it = iter(jobs)
        for job in it:
            inflight.append(pool.submit(decode, job))
            if len(inflight) >= prefetch:
                break
        while inflight:
            fut = inflight.pop(0)
            nxt = next(it, None)
            if nxt is not None:
                inflight.append(pool.submit(decode, nxt))
            yield fut.result()
