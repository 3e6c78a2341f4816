"""Randomized corruption fuzz sweep over every binary reader.

High-volume companion to tests/test_index_corruption.py (which pins a
small number of crafted regressions): this drives THOUSANDS of random
corruptions — truncations, bit flips, byte-run stomps, huge-integer
windows, chunk splices, appended garbage — through each reader (Python
AND native) and requires every trial to end in Python control: clean
success or a Python exception.  A native crash kills the per-format
child process and is reported with its seed; a hang trips the 15 s
alarm and is reported the same way.

Formats / readers covered (reference formats per SURVEY §2 / C4-C7):
  mdb   read_mdb / read_mdb_columnar / read_mdb_lazy / native mdb_scan
  midx  read_midx (text)
  frg   FragFileStorage + get_seq_by_id (corrupting .frg or .sdx)
  pdb   pdb_io.read_pdb (golden.pdb as the seed corpus)
  agc   AgcFile open + list + sub-seq fetch (reference test.agc)
  pga   PgaFile open + fetch (fresh create_pga archive as the corpus)
  fasta / fastagz  read_fastx_all (plain + gzip sniffing paths)
  gff   GFFDB.from_file (gzip GFF3 parse + attribute indexing)

Usage:  python scripts/fuzz_readers.py [n_trials_per_format]
        (CPU-only: the children run with JAX_PLATFORMS=cpu)

Parent mode fans out one child per format and prints a JSON summary;
child mode (--child FORMAT SEED0 N) runs the trials in-process.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REF_DATA = "/root/reference/pgr-db/test/test_data"
FORMATS = ("mdb", "midx", "frg", "pdb", "agc", "pga",
           "fasta", "fastagz", "gff")
TRIAL_ALARM_S = 15


def _mutate(src: bytes, rng) -> bytes:
    """One random corruption of src (always returns a changed buffer)."""
    buf = bytearray(src)
    op = rng.integers(0, 6)
    if op == 0 and len(buf) > 1:                      # truncate
        return bytes(buf[: int(rng.integers(0, len(buf)))])
    if op == 1:                                       # bit flips
        for p in rng.integers(0, len(buf), size=int(rng.integers(1, 17))):
            buf[p] ^= int(rng.integers(1, 256))
        return bytes(buf)
    if op == 2:                                       # byte-run stomp
        p = int(rng.integers(0, len(buf)))
        n = min(len(buf) - p, int(rng.integers(1, 64)))
        buf[p : p + n] = bytes([int(rng.integers(0, 2)) * 0xFF]) * n
        return bytes(buf)
    if op == 3 and len(buf) >= 8:                     # huge-int window
        p = int(rng.integers(0, len(buf) - 7))
        v = (1 << int(rng.integers(31, 64))) - int(rng.integers(0, 2))
        buf[p : p + 8] = v.to_bytes(8, "little")
        return bytes(buf)
    if op == 4 and len(buf) > 16:                     # chunk splice
        a = int(rng.integers(0, len(buf) - 8))
        n = min(len(buf) - a, int(rng.integers(4, 256)))
        b = int(rng.integers(0, max(1, len(buf) - n)))
        buf[b : b + n] = buf[a : a + n]
        return bytes(buf)
    return bytes(buf) + bytes(rng.integers(0, 256,    # appended garbage
                              size=int(rng.integers(1, 128))).astype("u1"))


class _TrialTimeout(Exception):
    pass


def _alarm(_sig, _frm):
    raise _TrialTimeout()


def _run_trials(fmt: str, seed0: int, n: int) -> dict:
    import numpy as np

    from pgrtk.core import mdb, pdb_io
    from pgrtk.core.agc import AgcFile
    from pgrtk.core.frag_io import FragFileStorage
    from pgrtk.core import pga as pga_mod
    from pgrtk.native import api as napi

    import tempfile

    tmp = tempfile.mkdtemp(prefix=f"fuzz_{fmt}_")
    pref = os.path.join(REF_DATA, "test_seqs_frag")

    if fmt == "mdb":
        src = open(pref + ".mdb", "rb").read()

        def attempt(path):
            mdb.read_mdb(path)
            mdb.read_mdb_columnar(path)
            mdb.read_mdb_lazy(path)
            if napi.available():
                napi.mdb_scan(path)

        def write(buf):
            p = os.path.join(tmp, "f.mdb")
            open(p, "wb").write(buf)
            return p

    elif fmt == "midx":
        src = open(pref + ".midx", "rb").read()

        def attempt(path):
            mdb.read_midx(path)

        def write(buf):
            p = os.path.join(tmp, "f.midx")
            open(p, "wb").write(buf)
            return p

    elif fmt == "frg":
        import shutil

        for ext in (".frg", ".sdx", ".mdb", ".midx"):
            shutil.copy(pref + ext, os.path.join(tmp, "f" + ext))
        srcs = {e: open(pref + e, "rb").read() for e in (".frg", ".sdx")}
        src = srcs[".frg"]  # placeholder; per-trial choice below

        def attempt(prefix):
            st = FragFileStorage(prefix)
            for sid in (0, 3, 7):
                st.get_seq_by_id(sid)

        def write(buf, ext=None):
            open(os.path.join(tmp, "f" + ext), "wb").write(buf)
            # restore the OTHER file so only one is corrupt per trial
            other = ".sdx" if ext == ".frg" else ".frg"
            open(os.path.join(tmp, "f" + other), "wb").write(srcs[other])
            return os.path.join(tmp, "f")

    elif fmt == "pdb":
        src = open(os.path.join(REPO, "tests", "data", "golden.pdb"),
                   "rb").read()

        def attempt(path):
            pdb_io.read_pdb(path)

        def write(buf):
            p = os.path.join(tmp, "f.pdb")
            open(p, "wb").write(buf)
            return p

    elif fmt == "agc":
        src = open(os.path.join(REF_DATA, "test.agc"), "rb").read()

        def attempt(path):
            f = AgcFile(path)
            for s in f.list_samples()[:2]:
                for ctg, ln in f.list_ctgs(s)[:2]:
                    f.get_sub_seq(s, ctg, 0, min(64, ln))

        def write(buf):
            p = os.path.join(tmp, "f.agc")
            open(p, "wb").write(buf)
            return p

    elif fmt == "pga":
        seq = ("ACGT" * 700)[:2700]
        fa = os.path.join(tmp, "s0.fa")
        with open(fa, "w") as f:
            f.write(f">ctg0\n{seq}\n>ctg1\n{seq[::-1]}\n>ctg2\n{seq[13:]}\n")
        base = os.path.join(tmp, "base.pga")
        pga_mod.create_pga(base, [fa])
        src = open(base, "rb").read()

        def attempt(path):
            f = pga_mod.PgaFile(path)
            for s in f.list_samples()[:2]:
                for ctg, ln in f.list_ctgs(s)[:2]:
                    f.get_sub_seq(s, ctg, 0, min(64, ln))

        def write(buf):
            p = os.path.join(tmp, "f.pga")
            open(p, "wb").write(buf)
            return p

    elif fmt in ("fasta", "fastagz", "gff"):
        from pgrtk.core.fasta import read_fastx_all
        from pgrtk.core.gff_db import GFFDB

        name = {"fasta": "test_seqs.fa", "fastagz": "test_seqs2.fa.gz",
                "gff": "test.gff3.gz"}[fmt]
        src = open(os.path.join(REF_DATA, name), "rb").read()

        def attempt(path):
            if fmt == "gff":
                GFFDB.from_file(path)
            else:
                read_fastx_all(path)

        def write(buf):
            p = os.path.join(tmp, "f_" + name)
            open(p, "wb").write(buf)
            return p

    else:
        raise SystemExit(f"unknown format {fmt}")

    signal.signal(signal.SIGALRM, _alarm)
    n_ok = n_exc = 0
    hangs = []
    for i in range(n):
        seed = seed0 + i
        rng = np.random.default_rng(seed)
        if fmt == "frg":
            ext = ".frg" if seed % 2 else ".sdx"
            target = write(_mutate(srcs[ext], rng), ext=ext)
        else:
            target = write(_mutate(src, rng))
        # stderr marks the active seed so a native crash is attributable
        print(f"SEED {seed}", file=sys.stderr, flush=True)
        signal.alarm(TRIAL_ALARM_S)
        try:
            attempt(target)
            n_ok += 1
        except _TrialTimeout:
            hangs.append(seed)
        except Exception:
            n_exc += 1
        finally:
            signal.alarm(0)
    return {"format": fmt, "trials": n, "ok": n_ok, "raised": n_exc,
            "hung": hangs}


def main():
    if len(sys.argv) >= 2 and sys.argv[1] == "--child":
        fmt, seed0, n = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
        print(json.dumps(_run_trials(fmt, seed0, n)))
        return

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    results, bad = [], 0
    for fmt in FORMATS:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             fmt, "1000000", str(n)],
            capture_output=True, text=True, env=env, cwd=REPO)
        if proc.returncode != 0:
            last_seed = [l for l in proc.stderr.splitlines()
                         if l.startswith("SEED ")]
            results.append({"format": fmt, "CRASH": True,
                            "returncode": proc.returncode,
                            "seed": last_seed[-1] if last_seed else "?",
                            "stderr_tail": proc.stderr[-500:]})
            bad += 1
            continue
        r = json.loads(proc.stdout.splitlines()[-1])
        if r["hung"]:
            bad += 1
        results.append(r)
    print(json.dumps({"per_format": results,
                      "clean": bad == 0}, indent=1))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
