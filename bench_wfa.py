"""Batched device WFA vs the native host path (SV-pipeline penalties).

Default: aligns G mutated ~400 bp gap segments once through ops/wfa.py
(device forward + host backtrace), once through the C++ arbiter on a
thread pool (the production host path), and once serially.  Prints one
JSON line with segments/s for all three.  Run standalone on a GPU
host, one process per card.

--sweep: the host/device crossover measurement — repeats the
comparison at segment lengths 256..4096 bp (the SV pipeline's
LengthDiff guard admits segments far beyond the ~400 bp typical case),
one JSON line per length.  Device batch sizes shrink with length (the
kernel's run-length plane is O(G * 2L * L) bytes).

--sv-dist: measures both paths on the REAL gap-segment distribution of
the SV pipeline — builds the planted-SV corpus of
tests/test_cli_suite.py::test_sv_pipeline_localizes_planted_events,
runs pgr-get-sv-candidate-regions up to segment collection (WFA call
intercepted), and times device vs host on exactly those pairs.
"""
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import numpy as np

    from pgrtk.core import wfa as host_wfa
    from pgrtk.ops import wfa as dev_wfa

    rng = np.random.RandomState(0)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def mutate(t):
        s = bytearray(t)
        for _ in range(int(rng.randint(1, 6))):
            p = rng.randint(16, len(s) - 16)
            s[p] = bases[(int(np.where(bases == s[p])[0][0]) + 1
                          + rng.randint(3)) % 4]
        for _ in range(int(rng.randint(0, 2))):
            p = rng.randint(16, len(s) - 40)
            del s[p : p + rng.randint(1, 25)]
        return bytes(s)

    G = int(os.environ.get("BENCH_WFA_SEGMENTS", "512"))
    pairs = []
    for _ in range(G):
        t = bytes(rng.choice(bases, int(rng.randint(200, 480))).tolist())
        pairs.append((t, mutate(t)))

    # device: warm-up compile, then timed
    out_dev = dev_wfa.batch_wfa_align(pairs)
    t0 = time.time()
    out_dev = dev_wfa.batch_wfa_align(pairs)
    dt_dev = time.time() - t0

    def host_one(p):
        t, q = p
        return host_wfa.wfa_align_bases(t.decode(), q.decode(), 384, 3, 3, 1)

    n_threads = os.cpu_count() or 4
    with ThreadPoolExecutor(n_threads) as pool:
        pool.map(host_one, pairs[:8])  # warm-up
    t0 = time.time()
    with ThreadPoolExecutor(n_threads) as pool:
        out_thr = list(pool.map(host_one, pairs))
    dt_thr = time.time() - t0

    t0 = time.time()
    out_ser = [host_one(p) for p in pairs[: max(1, G // 8)]]
    dt_ser = (time.time() - t0) * (G / max(1, G // 8))

    assert out_dev == out_thr, "device/host mismatch"
    assert out_ser == out_thr[: len(out_ser)]
    print(
        json.dumps(
            {
                "metric": "wfa_batch_speedup",
                "value": round(dt_thr / dt_dev, 2),
                "unit": "x vs threaded host",
                "segments": G,
                "host_threads": n_threads,
                "device_seg_per_s": round(G / dt_dev, 1),
                "threaded_host_seg_per_s": round(G / dt_thr, 1),
                "serial_host_seg_per_s": round(G / dt_ser, 1),
            }
        )
    )


def _time_paths(pairs, max_wf: int, skip_device: bool = False, **dev_kw):
    """Device + threaded-host + serial-host seg/s on one pair list.
    dev_kw: batch_wfa_align sizing (L segment cap, chunk batch size,
    S_max score cap) — segments exceeding them take the internal host
    fallback, so the device number is the PRODUCTION batch-path
    throughput at that config."""
    import numpy as np  # noqa: F401

    from pgrtk.core import wfa as host_wfa
    from pgrtk.ops import wfa as dev_wfa

    G = len(pairs)
    out = {}
    if not skip_device:
        dev = dev_wfa.batch_wfa_align(pairs, max_wf, 3, 3, 1, **dev_kw)
        t0 = time.time()
        dev = dev_wfa.batch_wfa_align(pairs, max_wf, 3, 3, 1, **dev_kw)
        out["device_seg_per_s"] = round(G / (time.time() - t0), 1)
    else:
        dev = None

    def host_one(p):
        t, q = p
        return host_wfa.wfa_align_bases(
            t.decode(), q.decode(), max_wf, 3, 3, 1
        )

    n_threads = os.cpu_count() or 4
    with ThreadPoolExecutor(n_threads) as pool:
        pool.map(host_one, pairs[: min(8, G)])  # warm-up
    t0 = time.time()
    with ThreadPoolExecutor(n_threads) as pool:
        out_thr = list(pool.map(host_one, pairs))
    out["threaded_host_seg_per_s"] = round(G / (time.time() - t0), 1)
    n_ser = max(1, G // 8)
    t0 = time.time()
    out_ser = [host_one(p) for p in pairs[:n_ser]]
    out["serial_host_seg_per_s"] = round(n_ser / (time.time() - t0), 1)
    assert out_ser == out_thr[:n_ser]
    if dev is not None:
        assert dev == out_thr, "device/host mismatch"
    bases = sum(len(t) for t, _ in pairs)
    out["mean_target_len"] = round(bases / G, 1)
    out["segments"] = G
    return out


def sweep():
    """Crossover measurement over segment length (VERDICT r3 item 6)."""
    import numpy as np

    rng = np.random.RandomState(1)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def mutate(t, snp=0.005, indels=2):
        s = bytearray(t)
        for _ in range(max(1, int(len(s) * snp))):
            p = rng.randint(8, len(s) - 8)
            s[p] = bases[(int(np.where(bases == s[p])[0][0]) + 1
                          + rng.randint(3)) % 4]
        for _ in range(rng.randint(1, indels + 1)):
            p = rng.randint(8, len(s) - 40)
            del s[p : p + rng.randint(1, 20)]
        return bytes(s)

    for L in (256, 512, 1024, 2048, 4096):
        # device memory: run-length plane is chunk * 2L * L bytes
        chunk = max(8, min(256, (1 << 28) // (2 * L * L)))
        G = max(64, 2 * chunk)
        pairs = []
        for _ in range(G):
            t = bytes(rng.choice(bases, L + rng.randint(-L // 8, L // 8))
                      .tolist())
            pairs.append((t, mutate(t)))
        rec = {"metric": "wfa_length_sweep", "target_len": L,
               "device_chunk": chunk}
        # segment cap L_pad covers the +L/8 jitter; S_max 512 covers the
        # 0.5% divergence at 4 kb (score ~ 3*SNPs + indel opens)
        rec.update(
            _time_paths(pairs, 384, L=L + L // 8 + 8, chunk=chunk,
                        S_max=512)
        )
        print(json.dumps(rec), flush=True)


def sv_dist():
    """Both paths on the SV pipeline's real gap-segment distribution."""
    import tempfile

    import numpy as np

    from pgrtk.cli import pgr_get_sv_candidate_regions as sv
    from pgrtk.core import wfa as core_wfa

    rng = np.random.default_rng(12)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = 400_000
    ref = rng.integers(0, 4, size=L, dtype=np.uint8)
    s = ref.copy()
    m = rng.random(L) < 0.002
    s[m] = (s[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
    DEL_AT, DEL_LEN, INS_AT, INS_LEN = 100_000, 1500, 300_000, 1000
    s = np.concatenate([s[:DEL_AT], s[DEL_AT + DEL_LEN:]])
    ins = rng.integers(0, 4, size=INS_LEN, dtype=np.uint8)
    s = np.concatenate([s[: INS_AT - DEL_LEN], ins, s[INS_AT - DEL_LEN:]])

    captured = []
    orig = core_wfa.batch_get_variant_segments

    def capture(pairs, *a, **kw):
        captured.extend(
            (t.encode() if isinstance(t, str) else bytes(t),
             q.encode() if isinstance(q, str) else bytes(q))
            for t, q in pairs
        )
        return orig(pairs, *a, **kw)

    sv.batch_get_variant_segments = capture
    try:
        with tempfile.TemporaryDirectory() as td:
            with open(f"{td}/ref.fa", "wb") as f:
                f.write(b">ref\n" + bases[ref].tobytes() + b"\n")
            with open(f"{td}/asm.fa", "wb") as f:
                f.write(b">asm\n" + bases[s].tobytes() + b"\n")
            sv.main([f"{td}/ref.fa", f"{td}/asm.fa", f"{td}/out",
                     "--number-of-thread", "1"])
    finally:
        sv.batch_get_variant_segments = orig

    lens = sorted(len(t) for t, _ in captured)
    rec = {
        "metric": "wfa_sv_segment_distribution",
        "segments": len(captured),
        "len_min": lens[0], "len_p50": lens[len(lens) // 2],
        "len_p90": lens[(len(lens) * 9) // 10], "len_max": lens[-1],
    }
    rec.update(_time_paths(captured, 384))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    if "--sweep" in sys.argv:
        sweep()
    elif "--sv-dist" in sys.argv:
        sv_dist()
    else:
        main()
