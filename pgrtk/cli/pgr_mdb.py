"""pgr-mdb equivalent: build .mdb/.midx index from compressed archives
(reference: pgr-bin/src/bin/pgr-mdb.rs).  Accepts both our .pga archives
and real AGC v2 .agc files (pgrtk.core.agc).  Index-only build (no fragment
bases), defaults w=80 k=56 r=4 min_span=64, optional --sketch mode.
"""
from __future__ import annotations

import argparse
import sys

from ..core.archive_pipeline import stream_archive
from ..core.seqdb import CompactSeqDB
from ..core.spec import ShmmrSpec


def main(argv=None):
    from ..utils.dispatch import init_cli_logging

    init_cli_logging()
    p = argparse.ArgumentParser(
        prog="pgr-mdb",
        description="Create pgr minimizer database with PGA archive backend",
    )
    p.add_argument("filepath", help="file listing the PGA archive paths")
    p.add_argument("prefix")
    p.add_argument("-w", type=int, default=80)
    p.add_argument("-k", type=int, default=56)
    p.add_argument("-r", type=int, default=4)
    p.add_argument("-m", "--min-span", type=int, default=64)
    p.add_argument("-s", "--sketch", action="store_true")
    p.add_argument(
        "-p", "--prefetching", action="store_true",
        help="prefetch archive contigs ahead of the sketcher (more "
        "memory, faster for archives with many small contigs — the "
        "reference's AGC prefetching flag, pgr-mdb.rs:44-46; here it "
        "deepens the reader pool's read-ahead window)",
    )
    p.add_argument("--number-of-readers", type=int, default=4)
    from ..utils.version import add_version_arg

    add_version_arg(p)
    args = p.parse_args(argv)

    spec = ShmmrSpec(
        w=args.w, k=args.k, r=args.r, min_span=args.min_span, sketch=args.sketch
    )
    db = CompactSeqDB(spec)
    with open(args.filepath) as f:
        archives = [line.strip() for line in f if line.strip()]
    for path in archives:
        # chunked streaming build: reader threads decode ahead of the
        # sketcher with bounded memory (core/archive_pipeline.py)
        for records in stream_archive(
            path,
            nthreads=args.number_of_readers,
            prefetch=16 if args.prefetching else 4,
            chunk_contigs=256 if args.prefetching else 1024,
        ):
            db.load_index_only(records)
    db.write_mdb_midx(args.prefix)
    return 0


if __name__ == "__main__":
    sys.exit(main())
