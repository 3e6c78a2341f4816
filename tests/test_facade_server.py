"""Facade method coverage + server pipeline tests."""
import json
import os
import threading
import urllib.request

import pytest

import pgrtk
from pgrtk.core.fasta import read_fastx_all


@pytest.fixture(scope="module")
def db(test_data_dir):
    d = pgrtk.SeqIndexDB()
    d.load_from_fastx(os.path.join(test_data_dir, "test_seqs.fa"))
    return d


def test_shmmr_pair_views(db):
    spec = db.get_shmmr_spec()
    assert spec == (80, 56, 4, 64, False)
    lst = db.get_shmmr_pair_list()
    assert lst
    # per-PAIR lookups (reference lib.rs:635-719 semantics)
    pairs = {(h0, h1) for h0, h1, *_ in lst}
    total = 0
    for pair in list(pairs)[:50]:
        c = db.get_shmmr_pair_count(pair)
        assert c > 0
        total += c
        by_src = db.get_shmmr_pair_source_count(pair, None)
        assert sum(v for _s, v in by_src) == c
        # strict < filter drops sources at/above the cap
        assert db.get_shmmr_pair_source_count(pair, 1) == [
            (s, v) for s, v in by_src if v < 1
        ]
    assert db.get_shmmr_pair_count((1, 2)) == 0  # absent pair
    # full-table mass agrees with the pair list
    assert sum(
        db.get_shmmr_pair_count(p) for p in pairs
    ) == len(lst)


def test_bundle_projection_external_sequence(db, test_data_dir):
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs2.fa.gz"))
    pbid, sid_smps = db.get_principal_bundle_projection(
        2, 8, [(0, recs[0].seq), (1, recs[1].seq)]
    )
    assert pbid
    smap = dict(sid_smps)
    assert set(smap) == {0, 1}
    # external sequences should project mostly onto the main bundle
    hits = sum(1 for _smp, b in smap[0] if b is not None)
    assert hits > len(smap[0]) // 2


def test_facade_consensus(db, test_data_dir):
    recs = read_fastx_all(os.path.join(test_data_dir, "consensus_test.fa"))
    mem = pgrtk.SeqIndexDB()
    mem.load_from_seq_list(
        [(str(i), r.seq) for i, r in enumerate(recs)],
        "memory", 33, 33, 1, 0,
    )
    out = mem.shmmr_sparse_aln_consensus([0], 2)
    assert out and out[0][0] == 0 and len(out[0][1][0][0]) > 1000


def test_write_midx_text(db, tmp_path):
    path = str(tmp_path / "t.midx")
    db.write_midx_to_text_file(path)
    lines = open(path).read().splitlines()
    assert len(lines) == len(db.seq_info)


def test_shmmr_dots_and_pairs(test_data_dir):
    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))[:2]
    x, y = pgrtk.get_shmmr_dots(recs[0].seq, recs[1].seq)
    assert len(x) == len(y) and len(x) > 0
    pairs = pgrtk.get_shmmr_pairs_from_seq(recs[0].seq)
    assert pairs and all(p[0] <= p[1] for p in pairs)


def test_server_roundtrip(test_data_dir):
    import http.server

    from pgrtk.server import main as sm
    from pgrtk.server.bundle_processing import SequenceQuerySpec

    d = pgrtk.SeqIndexDB()
    d.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))
    sm.Handler.seq_db = d
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), sm.Handler)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        r = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/get_number_of_ctgs"
        )
        assert r.headers["X-Pgrtk-Version"].startswith("pgrtk ")
        assert json.loads(r.read()) == 66
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}/api/version")
        assert json.loads(r.read()).startswith("pgrtk ")
        name, src, _l = d.seq_info[0]
        spec = SequenceQuerySpec(
            source=src, ctg=name, bgn=100, end=3000, padding=100,
            merge_range_tol=1000,
        )
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/post_query_for_json_data",
            data=json.dumps(spec.__dict__).encode(),
            headers={"Content-Type": "application/json"},
        )
        res = json.loads(urllib.request.urlopen(req).read())
        assert len(res["match_summary"]) > 50
        assert res["query"]["ctg"] == name
    finally:
        srv.shutdown()


def test_append_from_fastx_multi_file_build(test_data_dir, tmp_path):
    """pgr-make-frgdb semantics: a two-file build appends sequences with
    continuing sids and per-file sources, and queries hit both files'
    sequences (reference: ext.rs:183-199)."""
    import pgrtk
    from pgrtk.core.fasta import read_fastx_all

    recs = read_fastx_all(os.path.join(test_data_dir, "test_seqs.fa"))
    fa1, fa2 = tmp_path / "a.fa", tmp_path / "b.fa"
    with open(fa1, "w") as f:
        for r in recs[:5]:
            f.write(f">{r.id.decode()}\n{r.seq.decode()}\n")
    with open(fa2, "w") as f:
        for r in recs[5:10]:
            f.write(f">{r.id.decode()}\n{r.seq.decode()}\n")

    db = pgrtk.SeqIndexDB()
    db.load_from_fastx(str(fa1))
    db.append_from_fastx(str(fa2))
    assert len(db.seq_info) == 10
    # sids continue across files; sources name each file
    assert sorted(db.seq_info) == list(range(10))
    srcs = {info[1] for info in db.seq_info.values()}
    assert srcs == {str(fa1), str(fa2)}
    # a sequence from the SECOND file is queryable and self-hits
    q = recs[7].seq
    hits = db.query_fragment_to_hps(q, 0.025, None, None, None, 8, None, False)
    assert any(t_idx == 7 for t_idx, _segs in hits)
    # reconstruction across the append boundary
    assert db.get_seq_by_id(0) == recs[0].seq
    assert db.get_seq_by_id(9) == recs[9].seq


def test_websocket_roi_autocomplete():
    """/ws mirrors the reference protocol (pgr-server/src/main.rs:209-255):
    text prefix in, JSON map of matching ROI presets out."""
    import base64
    import hashlib
    import http.server
    import socket
    import struct

    from pgrtk.server import main as sm
    from pgrtk.server import ws

    rois = {
        "AMY1A": {"source": "s", "ctg": "c1", "bgn": 1, "end": 2},
        "AMY2B": {"source": "s", "ctg": "c2", "bgn": 3, "end": 4},
        "TBC1D3": {"source": "s", "ctg": "c3", "bgn": 5, "end": 6},
    }
    sm.Handler.rois = rois
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), sm.Handler)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        key = base64.b64encode(b"0123456789abcdef").decode()
        sock.sendall(
            (
                "GET /ws HTTP/1.1\r\n"
                f"Host: 127.0.0.1:{port}\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        f = sock.makefile("rb")
        status = f.readline()
        assert b"101" in status
        accept = None
        while True:
            line = f.readline().strip()
            if not line:
                break
            if line.lower().startswith(b"sec-websocket-accept:"):
                accept = line.split(b":", 1)[1].strip().decode()
        expect = base64.b64encode(
            hashlib.sha1((key + ws.GUID).encode()).digest()
        ).decode()
        assert accept == expect

        def send_text(txt):
            payload = txt.encode()
            mask = b"\x11\x22\x33\x44"
            masked = bytes(
                c ^ mask[i & 3] for i, c in enumerate(payload)
            )
            hdr = bytes([0x81])
            assert len(payload) < 126
            hdr += bytes([0x80 | len(payload)])
            sock.sendall(hdr + mask + masked)

        def recv_text():
            b0, b1 = f.read(2)
            assert b0 & 0x0F == 1
            ln = b1 & 0x7F
            if ln == 126:
                ln = struct.unpack(">H", f.read(2))[0]
            return f.read(ln).decode()

        send_text("AMY")
        res = json.loads(recv_text())
        assert sorted(res) == ["AMY1A", "AMY2B"]
        assert res["AMY1A"]["ctg"] == "c1"
        send_text("TBC")
        assert list(json.loads(recv_text())) == ["TBC1D3"]
        send_text("")
        assert json.loads(recv_text()) == {}
        send_text("ZZZ")
        assert json.loads(recv_text()) == {}
        # clean close
        sock.sendall(bytes([0x88, 0x80]) + b"\x00\x00\x00\x00")
        sock.close()
    finally:
        sm.Handler.rois = []
        srv.shutdown()


def test_websocket_fragmentation_and_length_cap():
    """FIN=0 text + continuation frames reassemble into one prefix
    query; a frame claiming an abusive length drops the connection
    instead of buffering it."""
    import base64
    import http.server
    import socket
    import struct

    from pgrtk.server import main as sm

    sm.Handler.rois = {"AMY1A": {"ctg": "c1"}, "AMY2B": {"ctg": "c2"}}
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), sm.Handler)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def connect():
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        key = base64.b64encode(b"0123456789abcdef").decode()
        sock.sendall(
            (
                "GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n\r\n"
            ).encode()
        )
        f = sock.makefile("rb")
        while f.readline().strip():
            pass
        return sock, f

    def masked(txt, fin, opcode):
        payload = txt.encode()
        mask = b"\x01\x02\x03\x04"
        body = bytes(c ^ mask[i & 3] for i, c in enumerate(payload))
        b0 = (0x80 if fin else 0) | opcode
        return bytes([b0, 0x80 | len(payload)]) + mask + body

    try:
        sock, f = connect()
        # "AM" + "Y1" as two fragments -> one "AMY1" prefix query
        sock.sendall(masked("AM", fin=False, opcode=1))
        sock.sendall(masked("Y1", fin=True, opcode=0))
        b0, b1 = f.read(2)
        ln = b1 & 0x7F
        if ln == 126:
            ln = struct.unpack(">H", f.read(2))[0]
        res = json.loads(f.read(ln))
        assert list(res) == ["AMY1A"]
        sock.close()

        # oversize length claim: server must close, not buffer
        sock, f = connect()
        hdr = bytes([0x81, 0x80 | 127]) + struct.pack(">Q", 1 << 40)
        sock.sendall(hdr + b"\x00\x00\x00\x00")
        assert f.read(2) == b""  # connection closed
        sock.close()
    finally:
        sm.Handler.rois = []
        srv.shutdown()


def test_server_decomposition_matches_and_svg(tmp_path):
    """End-to-end server flow with REAL matches (the roundtrip test only
    counts match_summary entries, which include empty lists): a 6-
    haplotype pangenome at ROI scale must clear bundle_processing.rs's
    num_hits > 100 / span > 0.6 summary filter for every haplotype, an
    SV haplotype must show its shorter target span, and the SVG route
    must paint one bundle path per haplotype."""
    import http.server
    import urllib.parse

    import numpy as np

    from pgrtk.server import main as sm

    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    L = 100_000
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    fa = tmp_path / "pan.fa"
    with open(fa, "w") as f:
        for h in range(6):
            s = base.copy()
            pos = rng.choice(L, size=int(L * 2e-4), replace=False)
            s[pos] = (s[pos] + rng.integers(1, 4, size=len(pos))) % 4
            if h == 3:  # 5 kb deletion SV
                s = np.concatenate([s[:40_000], s[45_000:]])
            f.write(f">hap_{h}\n{bases[s].tobytes().decode()}\n")

    d = pgrtk.SeqIndexDB()
    d.load_from_fastx(str(fa))
    sm.Handler.seq_db = d
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), sm.Handler)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        spec = dict(
            source=str(fa), ctg="hap_0",
            bgn=20_000, end=80_000, padding=0, merge_range_tol=100_000,
            w=48, k=56, r=4, min_span=12, sketch=True,
            min_cov=2, min_branch_size=8, bundle_length_cutoff=500,
            bundle_merge_distance=10_000,
        )
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/post_query_for_json_data",
            data=json.dumps(spec).encode(),
        )
        out = json.loads(urllib.request.urlopen(req).read())
        matched = {sid: v for sid, v in out["match_summary"] if v}
        assert len(matched) == 6  # every haplotype matched the ROI
        assert len(out["bundle_bed_records"]) == 6
        # the SV haplotype's target span is ~5 kb shorter
        spans = {
            sid: v[0]["t_end"] - v[0]["t_bgn"] for sid, v in matched.items()
        }
        normal = [s for sid, s in spans.items() if sid != 3]
        assert all(abs(s - normal[0]) < 1000 for s in normal)
        assert normal[0] - spans[3] > 4000
        assert all(v[0]["num_hits"] > 100 for v in matched.values())

        q = urllib.parse.quote(json.dumps(spec))
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/get_html_by_query?{q}"
        ).read().decode()
        assert "<svg" in html and html.count("<path") == 6
    finally:
        srv.shutdown()


def test_server_concurrent_queries_and_ws(test_data_dir):
    """The ThreadingHTTPServer shares ONE SeqIndexDB across handler
    threads — the reference gets isolation from axum + Arc
    (pgr-web/pgr-server/src/main.rs:60-158).  Fire concurrent
    /api/post_query_for_json_data requests for DIFFERENT regions plus
    parallel /ws sessions and assert every response is byte-equal to
    its single-threaded golden: no interleaved writes, no shared-cache
    cross-talk (VERDICT r4 item 7)."""
    import base64
    import hashlib
    import http.server
    import socket
    import struct

    from pgrtk.server import main as sm
    from pgrtk.server import ws
    from pgrtk.server.bundle_processing import SequenceQuerySpec

    d = pgrtk.SeqIndexDB()
    d.load_from_frg_index(os.path.join(test_data_dir, "test_seqs_frag"))
    sm.Handler.seq_db = d
    sm.Handler.rois = {
        "AMY1A": {"source": "s", "ctg": "c1", "bgn": 1, "end": 2},
        "AMY2B": {"source": "s", "ctg": "c2", "bgn": 3, "end": 4},
        "TBC1D3": {"source": "s", "ctg": "c3", "bgn": 5, "end": 6},
    }
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), sm.Handler)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def post_query(spec):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/post_query_for_json_data",
            data=json.dumps(spec.__dict__).encode(),
            headers={"Content-Type": "application/json"},
        )
        return urllib.request.urlopen(req, timeout=60).read()

    def ws_roundtrips():
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        key = base64.b64encode(os.urandom(16)).decode()
        sock.sendall(
            (
                "GET /ws HTTP/1.1\r\n"
                f"Host: 127.0.0.1:{port}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        f = sock.makefile("rb")
        assert b"101" in f.readline()
        while f.readline().strip():
            pass

        def send_text(txt):
            payload = txt.encode()
            mask = b"\x51\x62\x73\x84"
            masked = bytes(c ^ mask[i & 3] for i, c in enumerate(payload))
            sock.sendall(bytes([0x81, 0x80 | len(payload)]) + mask + masked)

        def recv_text():
            b0, b1 = f.read(2)
            assert b0 & 0x0F == 1
            ln = b1 & 0x7F
            if ln == 126:
                ln = struct.unpack(">H", f.read(2))[0]
            return f.read(ln).decode()

        out = []
        for prefix, expect in (
            ("AMY", ["AMY1A", "AMY2B"]),
            ("TBC", ["TBC1D3"]),
            ("AMY1", ["AMY1A"]),
        ) * 3:
            send_text(prefix)
            out.append((sorted(json.loads(recv_text())), expect))
        sock.close()
        return out

    try:
        specs = []
        for sid in (0, 7, 33):
            name, src, _l = d.seq_info[sid]
            specs.append(SequenceQuerySpec(
                source=src, ctg=name, bgn=100, end=3000, padding=100,
                merge_range_tol=1000,
            ))
        goldens = [post_query(s) for s in specs]
        assert len({g[:64] for g in goldens}) == 3  # distinct regions

        results = {}
        errors = []

        def worker(i):
            try:
                results[i] = post_query(specs[i % 3])
            except Exception as e:  # pragma: no cover
                errors.append((i, repr(e)))

        ws_results = {}

        def ws_worker(i):
            try:
                ws_results[i] = ws_roundtrips()
            except Exception as e:  # pragma: no cover
                errors.append(("ws", i, repr(e)))

        threads = [
            threading.Thread(target=worker, args=(i,)) for i in range(12)
        ] + [
            threading.Thread(target=ws_worker, args=(i,)) for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert len(results) == 12 and len(ws_results) == 4
        for i, body in results.items():
            assert body == goldens[i % 3], f"response {i} diverged"
        for rts in ws_results.values():
            for got, expect in rts:
                assert got == expect
    finally:
        srv.shutdown()
