"""Smoke run of the index build and batch query on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, on a
seeded region panel (48 haplotypes x 4 Mb at ~1e-3 SNPs, a shared tandem
and segmental duplication, a CNV in a minority of haplotypes, 16 ROI
queries of 200 kb-1 Mb), and holds every device result to its host
reference with zero tolerance:

  1. build the native library (make);
  2. mode-2 index build (pgr-mdb -s) and batch query (pgr-query), each
     dispatched to the device automatically, byte-identical to the host;
  3. mode-1 frg index (pgr-make-frgdb) and pgr-query --batch-device,
     byte-identical to pgr-query --host;
  4. the fused e2e query step at bench.py's operating point, anchors and
     chains equal to the host pipeline, and the index stage's pair set
     equal to the native sketcher's;
  5. the MAP-graph sort-link on the panel index's rows, device vs lexsort;
  6. the device WFA on 256 segment pairs cut from the panel vs the host.

With --four-cards it runs only the sharded index/query steps on a
4-device mesh (8 x 1 Mb per card) and their host parity.

Usage, one process per card (the process reserves the card's memory):
  python chip_smoke.py [--seed N]
  python chip_smoke.py --four-cards

Exits non-zero before any phase when JAX finds no GPU, and on any failed
phase.  The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import filecmp
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# panel and per-phase sizes of the default run
FULL = dict(
    panel=dict(n_haps=48, length=4_000_000, n_queries=16,
               query_len=(200_000, 1_000_000)),
    e2e=dict(B=8, L=1_048_576, qchunk=16, n_index_keys=4_194_304),
    adj_rows=262_144,
    wfa=dict(n_pairs=256, min_len=256, max_len=4096),
)


class SmokeError(AssertionError):
    """A device result differs from its host reference."""


def check(cond, what):
    if not cond:
        raise SmokeError(what)


class DispatchLog(logging.Handler):
    """Collects the package's dispatch decisions and chain fallbacks."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def reset(self):
        from pgrtk.utils import dispatch

        self.records.clear()
        dispatch._logged.clear()  # log every decision of the next phase

    def decisions(self):
        return [r.getMessage() for r in self.records
                if r.getMessage().startswith("dispatch ")]

    def chose_device(self, what):
        return any(m.startswith(f"dispatch {what}: device")
                   for m in self.decisions())

    def chain_host_fallbacks(self):
        """(groups re-run on the host, groups chained) over the phase."""
        runs = [r.args for r in self.records
                if r.msg.startswith("chain: ")]
        return sum(a[0] for a in runs), sum(a[1] for a in runs)


def _same_files(a_prefix, b_prefix, exts):
    """Byte-compare every `a_prefix*ext` file with its `b_prefix` twin."""
    d = os.path.dirname(a_prefix)
    a_base, b_base = os.path.basename(a_prefix), os.path.basename(b_prefix)
    names = sorted(f for f in os.listdir(d)
                   if f.startswith(a_base) and f.endswith(exts))
    for f in names:
        other = os.path.join(d, b_base + f[len(a_base):])
        check(filecmp.cmp(os.path.join(d, f), other, shallow=False),
              f"{f} differs from {os.path.basename(other)}")
    return len(names)


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------
def phase_native_build(**_):
    """Build libpgrtk.so from the tracked sources with its Makefile."""
    from pgrtk.native import api as native

    native_dir = os.path.join(REPO, "pgrtk", "native")
    proc = subprocess.run(
        ["make", "-C", native_dir, "-j", str(os.cpu_count() or 4)],
        capture_output=True, text=True,
    )
    check(proc.returncode == 0,
          f"native build failed (rc={proc.returncode}):\n{proc.stderr}")
    check(native.available(), "libpgrtk.so built but does not load")
    return dict(built=True)


def write_panel(work, panel):
    """FASTA per haplotype (one sample each), the query FASTA, the .pga
    archive and the list files the CLI tools read."""
    from pgrtk.core.pga import create_pga
    from pgrtk.utils import synth

    os.makedirs(os.path.join(work, "haps"), exist_ok=True)
    paths = []
    for name, seq in panel["haps"]:
        path = os.path.join(work, "haps", f"{name}.fa")
        synth.write_fasta(path, [(f"{name}#chr6_MHC", seq)])
        paths.append(path)
    synth.write_fasta(os.path.join(work, "roi.fa"), panel["queries"])
    create_pga(os.path.join(work, "panel.pga"), paths)
    with open(os.path.join(work, "archives.txt"), "w") as f:
        f.write(os.path.join(work, "panel.pga") + "\n")
    with open(os.path.join(work, "fastas.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")


def phase_mode2_cli(work, log, **_):
    """pgr-mdb -s and pgr-query, automatic dispatch vs host."""
    from pgrtk.cli import pgr_mdb, pgr_query

    archives = os.path.join(work, "archives.txt")
    pgr_mdb.main([archives, os.path.join(work, "panel"), "-s"])
    check(log.chose_device("sketch"),
          "pgr-mdb -s did not dispatch the sketch to the device")
    os.environ["PGRTK_SKETCH_BACKEND"] = "native"
    try:
        pgr_mdb.main([archives, os.path.join(work, "host"), "-s"])
    finally:
        del os.environ["PGRTK_SKETCH_BACKEND"]
    for ext in (".mdb", ".midx"):
        check(filecmp.cmp(os.path.join(work, "panel" + ext),
                          os.path.join(work, "host" + ext), shallow=False),
              f"device-built {ext} differs from the native sketcher's")

    roi = os.path.join(work, "roi.fa")
    pgr_query.main([os.path.join(work, "panel"), roi,
                    os.path.join(work, "q2dev")])
    check(log.chose_device("query"),
          "pgr-query did not dispatch the batch to the device")
    pgr_query.main([os.path.join(work, "panel"), roi,
                    os.path.join(work, "q2host"), "--host"])
    n_files = _same_files(os.path.join(work, "q2dev"),
                          os.path.join(work, "q2host"), (".hit", ".fa"))
    check(n_files > 0, "pgr-query wrote no output")
    n_host, n_groups = log.chain_host_fallbacks()
    return dict(mdb_bytes=os.path.getsize(os.path.join(work, "panel.mdb")),
                identical_files=n_files, chain_groups=n_groups,
                inexact_host_groups=n_host)


def phase_mode1_cli(work, log, **_):
    """pgr-make-frgdb (host mode-1 sketch), then pgr-query
    --batch-device vs --host on the frg index."""
    from pgrtk.cli import pgr_make_frgdb, pgr_query

    frg = os.path.join(work, "frg")
    pgr_make_frgdb.main([os.path.join(work, "fastas.txt"), frg])
    roi = os.path.join(work, "roi.fa")
    pgr_query.main([frg, roi, os.path.join(work, "q1dev"), "--frg-file",
                    "--batch-device"])
    pgr_query.main([frg, roi, os.path.join(work, "q1host"), "--frg-file",
                    "--host"])
    n_files = _same_files(os.path.join(work, "q1dev"),
                          os.path.join(work, "q1host"), (".hit", ".fa"))
    check(n_files > 0, "pgr-query wrote no output")
    n_host, n_groups = log.chain_host_fallbacks()
    return dict(identical_files=n_files, chain_groups=n_groups,
                inexact_host_groups=n_host)


def _native_pairs(targets):
    """Index-canonical pairs of each 2-bit target from the native
    sketcher, as sorted (k0, k1, sid, bgn, end, ori) rows."""
    from pgrtk.core import sketch as sketch_mod
    from pgrtk.core.spec import ShmmrSpec
    from pgrtk.utils import synth

    spec = ShmmrSpec(80, 56, 4, 64, True)
    rows = []
    for sid, t in enumerate(targets):
        mx, my = sketch_mod.sequence_to_shmmrs_arrays(
            sid, synth.to_ascii(t), spec, False)
        h = mx >> np.uint64(8)
        p = ((my & np.uint64(0xFFFFFFFF)) >> np.uint64(1)) + np.uint64(1)
        swap = h[:-1] > h[1:]
        rows.append(np.stack([
            np.where(swap, h[1:], h[:-1]), np.where(swap, h[:-1], h[1:]),
            np.full(len(swap), sid, np.uint64), p[:-1], p[1:],
            swap.astype(np.uint64)], axis=1))
    rows = np.concatenate(rows)
    return rows[np.lexsort(rows.T[::-1])]


def phase_e2e(e2e, **_):
    """query_e2e_step once at bench.py's operating point vs the host
    pipeline, and the index stage vs the native sketcher."""
    import jax
    import jax.numpy as jnp

    import bench
    from pgrtk.core import query as query_mod
    from pgrtk.core.spec import ShmmrSpec
    from pgrtk.ops import chain as chain_ops
    from pgrtk.utils import synth

    corpus = bench.bench_corpus(**e2e, build_lookup=True)
    step = jax.jit(bench.query_step(corpus))
    res = step(jnp.asarray(corpus["queries"]), *bench.query_tables(corpus))
    res = {k: np.asarray(v) for k, v in res.items()}
    flags = bench.e2e_flags(res)
    bench.check_e2e_flags(flags)

    lookup = corpus["idx"]["lookup"]
    spec = ShmmrSpec(80, 56, 4, 64, True)
    C = corpus["C"]
    dev_chains = chain_ops.traceback(
        res["scores"], res["prev"], res["gvalid"], res["anchors"])
    n_anchor_groups = n_chain_groups = 0
    for b, q in enumerate(corpus["queries"]):
        raw = query_mod.raw_query_fragment(
            lambda s0, s1: lookup.get((s0, s1), []), synth.to_ascii(q), spec)
        th = query_mod.collect_target_hits(raw)
        host_chains = dict(query_mod.query_fragment_to_hps(raw, 0.025))
        for c in range(C):
            g = b * C + c
            dev = [tuple(int(v) for v in row)
                   for row in res["anchors"][g][res["gvalid"][g]]]
            host = [(*lft, *t) for lft, t in th.get(c, [])]
            check(dev == host, f"e2e anchors differ: query {b} target {c}")
            n_anchor_groups += 1
            if len(host) > 1:
                hch, dch = host_chains[c], dev_chains[g]
                check(len(hch) == len(dch),
                      f"e2e chain count differs: query {b} target {c}")
                for (hs, htr), (ds, dtr) in zip(hch, dch):
                    check(np.float32(hs) == np.float32(ds),
                          f"e2e f32 chain score differs: query {b} "
                          f"target {c}: host {hs!r} device {ds!r}")
                    check(htr == dtr,
                          f"e2e chain track differs: query {b} target {c}")
                n_chain_groups += 1

    targets = corpus["targets"]
    B, L = targets.shape
    table, ovf = jax.jit(bench.index_stage)(
        jnp.asarray(targets), jnp.full((B,), L, jnp.int32))
    check(not bool(ovf), "index stage overflowed")
    t = {k: np.asarray(v) for k, v in table.items()}
    v = t["valid"]
    u64 = np.uint64
    dev = np.stack([
        (t["k0_hi"][v].astype(u64) << u64(32)) | t["k0_lo"][v],
        (t["k1_hi"][v].astype(u64) << u64(32)) | t["k1_lo"][v],
        t["sid"][v].astype(u64), t["bgn"][v].astype(u64),
        t["end"][v].astype(u64), t["orientation"][v].astype(u64)], axis=1)
    dev = dev[np.lexsort(dev.T[::-1])]
    host = _native_pairs(targets)
    check(dev.shape == host.shape and (dev == host).all(),
          f"index-stage pairs differ from the native sketcher's "
          f"({len(dev)} vs {len(host)})")
    return dict(flags, anchor_groups=n_anchor_groups,
                chain_groups=n_chain_groups, index_pairs=len(host))


def phase_sort_link(work, min_rows, **_):
    """ops/adj.sort_link_rows on device vs the host lexsort, on the
    (sid, bgn, end, h0, h1, ori) rows of the phase-2 index."""
    from pgrtk.core import mdb
    from pgrtk.ops import adj

    _spec, keys, starts, counts, sigs = mdb.read_mdb_columnar(
        os.path.join(work, "panel.mdb"))
    key_of = np.repeat(np.arange(len(keys)), counts)
    order = np.concatenate([np.arange(s, s + c) for s, c in
                            zip(starts, counts)]) if len(keys) else []
    sigs = sigs[order]
    rows = np.stack([
        sigs["seq_id"], sigs["bgn"], sigs["end"], keys[key_of, 0],
        keys[key_of, 1], sigs["orientation"]], axis=1).astype(np.uint64)
    check(len(rows) >= min_rows, f"{len(rows)} index rows < {min_rows}")
    mask = counts[key_of] >= 2
    d_rows, d_link = adj.sort_link_rows(rows, mask, device=True)
    h_rows, h_link = adj.sort_link_rows(rows, mask, device=False)
    check((d_rows == h_rows).all(), "sort-link rows differ")
    check((d_link == h_link).all(), "sort-link links differ")
    return dict(rows=len(rows), links=int(h_link.sum()))


def wfa_pairs(panel, n_pairs, min_len, max_len, seed):
    """(target, query) segment pairs: the same locus of two panel
    haplotypes, the query with 0-3 small seeded indels."""
    from pgrtk.utils import synth

    rng = np.random.default_rng(seed)
    haps = [s for _n, s in panel["haps"]]
    pairs = []
    for _ in range(n_pairs):
        n = int(np.exp(rng.uniform(np.log(min_len), np.log(max_len))))
        i, j = rng.choice(len(haps), size=2, replace=False)
        at = int(rng.integers(0, len(haps[i]) - n))
        q = haps[j][at:at + n]
        for _k in range(int(rng.integers(0, 4))):
            p = int(rng.integers(1, len(q) - 1))
            d = int(rng.integers(1, 9))
            if rng.random() < 0.5:
                q = np.concatenate([q[:p], q[p + d:]])
            else:
                q = np.concatenate(
                    [q[:p], rng.integers(0, 4, d, dtype=np.uint8), q[p:]])
        pairs.append((synth.to_ascii(haps[i][at:at + n]), synth.to_ascii(q)))
    return pairs


def phase_wfa(panel, wfa, seed, **_):
    """core/wfa.batch_get_variant_segments forced onto the device vs the
    host path (segments longer than the kernel's L run on the host)."""
    from pgrtk.core import wfa as core_wfa

    pairs = wfa_pairs(panel, seed=seed, **wfa)
    args = (1, 384, 3, 3, 1)
    dev = core_wfa.batch_get_variant_segments(
        pairs, *args, force_device="device")
    host = core_wfa.batch_get_variant_segments(pairs, *args)
    check(dev == host, "device WFA variants differ from the host's")
    return dict(pairs=len(pairs),
                on_device=sum(max(len(t), len(q)) <= 512 for t, q in pairs),
                incomplete=sum(v is None for v in host),
                variants=sum(len(v) for v in host if v is not None))


def phase_four_cards(n_devices=4, per_device=8, length=1_048_576, **_):
    """The sharded steps on an n-device mesh with host content parity;
    every output must be spread over the whole mesh."""
    import __graft_entry__

    res = __graft_entry__.dryrun_multichip(
        n_devices, per_device=per_device, length=length)
    for name, n in res["device_sets"].items():
        check(n == n_devices, f"{name} lives on {n} of {n_devices} devices")
    return res


# ---------------------------------------------------------------------
# running the phases
# ---------------------------------------------------------------------
def run_phase(name, fn, log, dev, **kw):
    """Run one phase and print its line: wall and compile time, peak
    device bytes so far, dispatch decisions, parity counts."""
    import jax

    from pgrtk.utils import gpu

    compile_s = [0.0]

    def on_event(event, duration, **_kw):
        if event.endswith("backend_compile_duration"):
            compile_s[0] += duration

    jax.monitoring.register_event_duration_secs_listener(on_event)
    log.reset()
    t0 = time.time()
    try:
        counts = fn(log=log, **kw)
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)
    line = dict(
        phase=name, wall_s=time.time() - t0, compile_s=compile_s[0],
        peak_bytes_in_use=gpu.peak_bytes_in_use(dev),
        dispatch=log.decisions(), counts=counts,
    )
    print("phase " + json.dumps(line, default=str), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1,
                    help="seed of the panel and the WFA segment pairs")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded steps on a 4-device mesh")
    args = ap.parse_args(argv)

    from pgrtk.utils import gpu

    devs = gpu.require_gpu("chip_smoke")
    dev = devs[0]
    print(f"device platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(devs)}", flush=True)
    for name, power in gpu.card_info():
        print(f"card {name}, {power}", flush=True)

    from pgrtk.utils.dispatch import init_cli_logging, log as pkg_log

    init_cli_logging()
    log = DispatchLog()
    pkg_log.addHandler(log)

    if args.four_cards:
        if len(devs) < 4:
            sys.exit(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devs)}")
        run_phase("four_cards", phase_four_cards, log, dev)
    else:
        from pgrtk.utils import synth

        with tempfile.TemporaryDirectory() as work:
            run_phase("native_build", phase_native_build, log, dev)
            panel = synth.region_panel(args.seed, **FULL["panel"])
            write_panel(work, panel)
            run_phase("mode2_cli", phase_mode2_cli, log, dev, work=work)
            run_phase("mode1_cli", phase_mode1_cli, log, dev, work=work)
            run_phase("e2e", phase_e2e, log, dev, e2e=FULL["e2e"])
            run_phase("sort_link", phase_sort_link, log, dev, work=work,
                      min_rows=FULL["adj_rows"])
            run_phase("wfa", phase_wfa, log, dev, panel=panel,
                      wfa=FULL["wfa"], seed=args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
