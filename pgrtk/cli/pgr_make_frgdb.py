"""pgr-make-frgdb equivalent: build .frg/.sdx/.mdb/.midx from fastx files.

Mirrors the reference CLI (pgr-bin/src/bin/pgr-make-frgdb.rs:34-67):
input is a file listing fastx paths; defaults w=80 k=56 r=4 min_span=64.
"""
from __future__ import annotations

import argparse
import sys

from ..api import SeqIndexDB


def main(argv=None):
    from ..utils.dispatch import init_cli_logging

    init_cli_logging()
    p = argparse.ArgumentParser(
        prog="pgr-make-frgdb",
        description="Create PGR-TK fragment minimizer database with frg "
        "format backend (JAX implementation)",
    )
    p.add_argument("filepath", help="file containing paths to fastx files")
    p.add_argument("prefix")
    p.add_argument("-w", type=int, default=80)
    p.add_argument("-k", type=int, default=56)
    p.add_argument("-r", type=int, default=4)
    p.add_argument("-m", "--min-span", type=int, default=64, dest="min_span")
    from ..utils.version import add_version_arg

    add_version_arg(p)
    args = p.parse_args(argv)

    db = SeqIndexDB()
    with open(args.filepath) as f:
        paths = [line.strip() for line in f if line.strip()]
    for i, path in enumerate(paths):
        if i == 0:
            db.load_from_fastx(path, args.w, args.k, args.r, args.min_span)
        else:
            db.append_from_fastx(path)
    db.write_frag_and_index_files(args.prefix)
    return 0


if __name__ == "__main__":
    sys.exit(main())
