"""pgr-server equivalent: HTTP service over a SeqIndexDB
(reference: pgr-web/pgr-server/src/main.rs).

Routes (same paths as the reference axum server):
  GET  /api/get_number_of_ctgs
  POST /api/post_query_for_json_data    body: SequenceQuerySpec JSON
  GET  /api/get_html_by_query?<url-encoded SequenceQuerySpec JSON>
  GET  /api/get_rois                     (full ROI preset map)
  GET  /ws                               (RFC 6455 websocket: client
                                          sends a name prefix, server
                                          answers the matching ROI map —
                                          pgr-server/src/main.rs:209-255)
  static files from --static-dir with index.html fallback

stdlib http.server (no third-party web framework in this environment);
CORS is wide-open like the reference's CorsLayer::new().allow_origin(Any).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..api import SeqIndexDB
from ..utils.version import version_string

log = logging.getLogger("pgrtk")
from .bundle_processing import (
    SequenceQuerySpec,
    get_target_and_principal_bundle_decomposition,
    pb_data_to_html_string,
)


class Handler(BaseHTTPRequestHandler):
    seq_db: SeqIndexDB = None
    static_dir: str = "."
    rois: list = []

    def _send(self, code, body, ctype="application/json"):
        data = body if isinstance(body, bytes) else body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "*")
        self.send_header("Access-Control-Allow-Headers", "*")
        self.send_header("X-Pgrtk-Version", version_string())
        self.end_headers()
        self.wfile.write(data)
        self._status = code

    def handle_one_request(self):
        # request tracing (the reference's tower-http TraceLayer,
        # pgr-web/pgr-server/src/main.rs:116): method, path, status, ms
        self._status = None
        t0 = time.monotonic()
        super().handle_one_request()
        if getattr(self, "command", None) and self._status is not None:
            log.info(
                "%s %s -> %d (%.1f ms)",
                self.command, self.path, self._status,
                1e3 * (time.monotonic() - t0),
            )

    def do_OPTIONS(self):
        self._send(200, "")

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path == "/api/version":
            self._send(200, json.dumps(version_string()))
        elif parsed.path == "/api/get_number_of_ctgs":
            self._send(200, json.dumps(len(self.seq_db.seq_info)))
        elif parsed.path == "/api/get_html_by_query":
            try:
                spec_json = urllib.parse.unquote(parsed.query)
                spec = SequenceQuerySpec(**json.loads(spec_json))
                targets = get_target_and_principal_bundle_decomposition(
                    spec, self.seq_db
                )
                html = pb_data_to_html_string(targets)
                self._send(200, html, "text/html")
            except Exception as e:  # noqa: BLE001
                self._send(400, json.dumps({"error": str(e)}))
        elif parsed.path == "/api/get_rois":
            self._send(200, json.dumps(self.rois))
        elif parsed.path == "/ws" and (
            self.headers.get("Upgrade", "").lower() == "websocket"
        ):
            self._handle_ws()
        else:
            self._serve_static(parsed.path)

    def _handle_ws(self):
        """ROI autocomplete over websocket (reference protocol,
        pgr-web/pgr-server/src/main.rs:209-255): text message = name
        prefix; reply = JSON object of ROI entries whose name starts
        with it; empty message -> {}."""
        from . import ws

        if not ws.handshake(self):
            self._send(400, json.dumps({"error": "bad websocket request"}))
            return
        self._status = 101
        self.close_connection = True
        rois = self.rois if isinstance(self.rois, dict) else {}

        def respond(prefix: str) -> str:
            if not prefix:
                return "{}"
            keys = sorted(k for k in rois if k.startswith(prefix))
            return json.dumps({k: rois[k] for k in keys})

        try:
            ws.serve_text(self, respond)
        except (OSError, ValueError):
            pass  # client went away mid-frame

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path == "/api/post_query_for_json_data":
            try:
                n = int(self.headers.get("Content-Length", 0))
                spec = SequenceQuerySpec(**json.loads(self.rfile.read(n)))
                targets = get_target_and_principal_bundle_decomposition(
                    spec, self.seq_db
                )
                self._send(200, json.dumps(targets))
            except Exception as e:  # noqa: BLE001
                self._send(400, json.dumps({"error": str(e)}))
        else:
            self._send(404, json.dumps({"error": "not found"}))

    def _serve_static(self, path):
        rel = path.lstrip("/") or "index.html"
        full = os.path.normpath(os.path.join(self.static_dir, rel))
        if not full.startswith(os.path.normpath(self.static_dir)):
            self._send(404, "not found", "text/plain")
            return
        if not os.path.isfile(full):
            full = os.path.join(self.static_dir, "index.html")
            if not os.path.isfile(full):
                self._send(404, "index file not found", "text/plain")
                return
        ctype = "text/html"
        if full.endswith(".js"):
            ctype = "application/javascript"
        elif full.endswith(".css"):
            ctype = "text/css"
        elif full.endswith(".json"):
            ctype = "application/json"
        with open(full, "rb") as f:
            self._send(200, f.read(), ctype)

    def log_message(self, fmt, *args):  # quieter default logging
        sys.stderr.write(
            "%s - %s\n" % (self.address_string(), fmt % args)
        )


def main(argv=None):
    from ..utils.dispatch import init_cli_logging

    init_cli_logging()
    p = argparse.ArgumentParser(prog="pgr-server")
    p.add_argument("data_path_prefix")
    p.add_argument("--frg-file", action="store_true")
    p.add_argument("--addr", default="127.0.0.1")
    p.add_argument("--port", type=int, default=3000)
    p.add_argument("--static-dir", default="./dist")
    p.add_argument("--rois-json", default=None)
    p.add_argument(
        "--version", action="version", version=version_string()
    )
    args = p.parse_args(argv)
    log.info("starting %s", version_string())

    db = SeqIndexDB()
    if args.frg_file:
        db.load_from_frg_index(args.data_path_prefix)
    else:
        db.load_from_agc_index(args.data_path_prefix)

    Handler.seq_db = db
    Handler.static_dir = args.static_dir
    if args.rois_json:
        with open(args.rois_json) as f:
            Handler.rois = json.load(f)

    server = ThreadingHTTPServer((args.addr, args.port), Handler)
    print(f"listening on {args.addr}:{args.port}")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
