"""pgr-pbundle-decomp equivalent: fasta -> MAP-graph GFA, principal-bundle
GFA, bundle decomposition BED + contig summary + .pdb checkpoint.

Mirrors the reference CLI (pgr-bin/src/bin/pgr-pbundle-decomp.rs):
defaults w=48 k=56 r=4 min_span=12 min_cov=0 min_branch_size=8
bundle_length_cutoff=2500 bundle_merge_distance=10000; BED rows
"ctg\tbgn\tend\tbid:size:dir:vbgn:vend:R|U".
"""
from __future__ import annotations

import argparse
import sys

from ..api import SeqIndexDB, get_principal_bundle_decomposition
from ..core import pdb_io


def group_smps_by_principle_bundle_id(smps, bundle_length_cutoff, bundle_merge_distance):
    """(reference: pgr-pbundle-decomp.rs:61-137)"""
    pre_bid = None
    pre_d = None
    all_partitions = []
    new_partition = []
    for smp, bundle_info in smps:
        if bundle_info is None:
            continue
        d = 0 if smp[4] == bundle_info[1] else 1
        bid = bundle_info[0]
        bpos = bundle_info[2]
        if pre_bid is None:
            new_partition = [(smp, bid, d, bpos)]
            pre_bid = bid
            pre_d = d
            continue
        if bid != pre_bid or d != pre_d:
            if new_partition[-1][0][3] - new_partition[0][0][2] > bundle_length_cutoff:
                all_partitions.append(new_partition)
            new_partition = []
            pre_bid = bid
            pre_d = d
        new_partition.append((smp, bid, d, bpos))
    if (
        new_partition
        and new_partition[-1][0][3] - new_partition[0][0][2] > bundle_length_cutoff
    ):
        all_partitions.append(new_partition)

    rtn = []
    if not all_partitions:
        return rtn
    partition = all_partitions[0]
    for p in all_partitions[1:]:
        p_end = partition[-1][0][3]
        p_bid = partition[-1][1]
        p_d = partition[-1][2]
        if (
            p_bid == p[0][1]
            and p_d == p[0][2]
            and abs(p[0][0][2] - p_end) < bundle_merge_distance
        ):
            partition.extend(p)
        else:
            rtn.append(partition)
            partition = p
    if partition:
        rtn.append(partition)
    return rtn


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="pgr-pbundle-decomp",
        description="Generate the principal bundle decomposition through "
        "the MAP Graph from a fasta file (JAX implementation)",
    )
    p.add_argument("fastx_path")
    p.add_argument("output_prefix")
    p.add_argument("--precomputed-bundles", "-p", default=None)
    p.add_argument("--include", "-i", default=None)
    p.add_argument("--decomp-fastx-path", "-d", default=None)
    p.add_argument("-w", type=int, default=48)
    p.add_argument("-k", type=int, default=56)
    p.add_argument("-r", type=int, default=4)
    p.add_argument("--min-span", type=int, default=12)
    p.add_argument("--min-cov", type=int, default=0)
    p.add_argument("--min-branch-size", type=int, default=8)
    p.add_argument("--bundle-length-cutoff", type=int, default=2500)
    p.add_argument("--bundle-merge-distance", type=int, default=10000)
    from ..utils.version import add_version_arg

    add_version_arg(p)
    args = p.parse_args(argv)
    cmd_string = " ".join(sys.argv if argv is None else ["pgr-pbundle-decomp"] + argv)

    seq_index_db = SeqIndexDB()
    if args.precomputed_bundles:
        (w, k, r, min_span, min_branch_size, min_cov, pbid, vertex_map) = (
            pdb_io.read_pdb(args.precomputed_bundles)
        )
        args.w, args.k, args.r = w, k, r
        args.min_span = min_span
        args.min_branch_size = min_branch_size
        args.min_cov = min_cov
    else:
        seq_index_db.load_from_fastx(
            args.fastx_path, args.w, args.k, args.r, args.min_span
        )
        pbid, vertex_map = seq_index_db.get_principal_bundles_with_id(
            args.min_cov, args.min_branch_size, None
        )

    decomp_fastx_path = args.decomp_fastx_path or args.fastx_path
    decomp_db = SeqIndexDB()
    decomp_db.load_from_fastx(
        decomp_fastx_path, args.w, args.k, args.r, args.min_span
    )

    if args.include:
        with open(args.include) as f:
            include_ctgs = {line.strip() for line in f if line.strip()}
        seq_list = [
            (ctg, decomp_db.get_seq(decomp_fastx_path, ctg))
            for ctg in sorted(include_ctgs)
        ]
        new_db = SeqIndexDB()
        new_db.load_from_seq_list(
            seq_list, decomp_fastx_path, args.w, args.k, args.r, args.min_span
        )
        decomp_db = new_db

    prefix = args.output_prefix
    if not args.precomputed_bundles:
        seq_index_db.generate_mapg_gfa(0, prefix + ".mapg.gfa", "from_fragmap")
        seq_index_db.write_mapg_idx(prefix + ".mapg.idx")
        seq_index_db.generate_principal_mapg_gfa(
            args.min_cov, args.min_branch_size, prefix + ".pmapg.gfa"
        )
        pdb_io.write_pdb(
            prefix + ".pdb",
            args.w,
            args.k,
            args.r,
            args.min_span,
            args.min_branch_size,
            args.min_cov,
            pbid,
            vertex_map,
        )

    sid_smps = dict(get_principal_bundle_decomposition(vertex_map, decomp_db))
    bid_to_size = {b[0]: len(b[2]) for b in pbid}
    seq_info = sorted(decomp_db.seq_info.items(), key=lambda kv: kv[1][0])

    repeat_count = {}
    non_repeat_count = {}
    with open(prefix + ".bed", "w") as bed, open(
        prefix + ".ctg.summary.tsv", "w"
    ) as summary:
        bed.write(f"# cmd: {cmd_string}\n")
        for sid, (ctg, _src, _len) in seq_info:
            smps = sid_smps[sid]
            partitions = group_smps_by_principle_bundle_id(
                smps, args.bundle_length_cutoff, args.bundle_merge_distance
            )
            ctg_bundle_count = {}
            for part in partitions:
                bid = part[0][1]
                ctg_bundle_count[bid] = ctg_bundle_count.get(bid, 0) + 1
            for part in partitions:
                b = part[0][0][2]
                e = part[-1][0][3] + args.k
                bid = part[0][1]
                direction = part[0][2]
                if ctg_bundle_count.get(bid, 0) > 1:
                    repeat_count.setdefault(sid, []).append(e - b - args.k)
                    is_repeat = "R"
                else:
                    non_repeat_count.setdefault(sid, []).append(e - b - args.k)
                    is_repeat = "U"
                bed.write(
                    f"{ctg}\t{b}\t{e}\t{bid}:{bid_to_size[bid]}:{direction}:"
                    f"{part[0][3]}:{part[-1][3]}:{is_repeat}\n"
                )

        summary.write(
            "#"
            + "\t".join(
                [
                    "ctg", "length", "repeat_bundle_count", "repeat_bundle_sum",
                    "repeat_bundle_percentage", "repeat_bundle_mean",
                    "repeat_bundle_min", "repeat_bundle_max",
                    "non_repeat_bundle_count", "non_repeat_bundle_sum",
                    "non_repeat_bundle_percentage", "non_repeat_bundle_mean",
                    "non_repeat_bundle_min", "non_repeat_bundle_max",
                    "total_bundle_count", "total_bundle_coverage_percentage",
                ]
            )
            + "\n"
        )

        def fmt_f32(v):
            # mimic Rust's shortest-roundtrip f32 Display
            import numpy as np

            return np.format_float_positional(
                np.float32(v), unique=True, trim="-"
            )

        for sid, (ctg, _src, length) in seq_info:
            rep = repeat_count.get(sid, [])
            non = non_repeat_count.get(sid, [])
            rep_sum = sum(rep)
            non_sum = sum(non)
            row = [
                ctg,
                str(length),
                str(len(rep)),
                str(rep_sum),
                fmt_f32(100.0 * rep_sum / length),
                fmt_f32(sum(rep) / len(rep)) if rep else "NA",
                str(min(rep)) if rep else "NA",
                str(max(rep)) if rep else "NA",
                str(len(non)),
                str(non_sum),
                fmt_f32(100.0 * non_sum / length),
                fmt_f32(sum(non) / len(non)) if non else "NA",
                str(min(non)) if non else "NA",
                str(max(non)) if non else "NA",
                str(len(rep) + len(non)),
                fmt_f32(100.0 * (rep_sum + non_sum) / length),
            ]
            summary.write("\t".join(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
