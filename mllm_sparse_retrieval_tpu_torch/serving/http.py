"""Threaded HTTP front end for :class:`RetrievalService`, stdlib only (a
copy of the JAX package's ``serving/http.py``).

One POST /search call may carry many queries; each query is submitted to
the service's micro-batcher INDIVIDUALLY, so queries from concurrent HTTP
connections coalesce into the same device batch (the threading server gives
each connection its own thread; the batcher's single dispatcher thread owns
the device). Endpoint routing lives in serving/router.py, shared with the
asyncio front end (serving/aio.py — the higher-throughput default; this
server is the zero-magic debugging fallback). Endpoints:

- ``POST /search``  body ``{"queries": [{"terms": {"17": 2.0} | [[17, 2.0],
  ...], "dense": [...], "depth": 10}, ...]}`` (or one query object) ->
  ``{"results": [[[doc_id, score], ...], ...]}`` score-descending. A query
  may instead carry ``"text": "a dog on a beach"`` when the service has a
  query encoder (live model encode on the device). ``"image_b64"`` is a
  400: the port has no image file decoder yet (ROADMAP Queue 1 #8b).
- ``GET /healthz``  -> ``{"ok": true, "mode": ...}``
- ``GET /stats``    -> micro-batcher counters (batches, items, mean size;
  plus live doc/segment counts when serving live indexes).
- ``GET /metrics``  -> the same counters plus a per-batch latency
  histogram in Prometheus text exposition format (scrape-ready).

When the service wraps live indexes (``index/arena.py``,
``index/live.py``) the corpus is mutable while serving:

- ``POST /documents`` body ``{"documents": [{"id": "d1", "dense": [...],
  "terms": {...}}, ...]}`` (what the mode needs) -> ``{"added": n}``;
  re-adding an id replaces it (latest wins).
- ``POST /documents/delete`` body ``{"ids": ["d1", ...]}`` ->
  ``{"deleted": n}`` (n = ids that were live).
- ``POST /compact`` -> per-engine segment counts after merging.
- ``POST /save`` body ``{}`` or ``{"directory": ...}`` -> persist the live
  state (segments + tombstones) to the given directory or the server's
  configured ``--live-state`` dir; a restart resumes from it.

- ``POST /reload`` body ``{}`` or ``{"passage_reps": path,
  "sparse_index": path}`` (static serving only) -> zero-downtime hot swap
  to freshly built artifacts: loaded with the server's boot-time
  dtype/ANN flags, registered filters rebuilt against the new doc orders,
  in-flight batches finish on the old engines.

Doc filters (tenant scoping, static indexes only — index/filter.py):

- ``POST /filters`` body ``{"name": "tenant-a", "ids": [...],
  "mode": "allow"|"deny"}`` registers (or replaces) a named filter;
  ``GET /filters`` lists names. A query object may then carry
  ``"filter": "tenant-a"`` to search only its allowed docs.

JSON object keys are always strings; for int-keyed impact indexes term keys
are coerced back to token ids in the router.
"""

from __future__ import annotations

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mllm_sparse_retrieval_tpu_torch.serving import router as _router
from mllm_sparse_retrieval_tpu_torch.serving.service import RetrievalService


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries .service (see make_server)
    protocol_version = "HTTP/1.1"

    def _respond(self, res: _router.Response) -> None:
        self.send_response(res.status)
        self.send_header("Content-Type", res.content_type)
        self.send_header("Content-Length", str(len(res.body)))
        self.end_headers()
        self.wfile.write(res.body)

    def log_message(self, fmt, *args):  # noqa: D102 — quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def do_GET(self):  # noqa: N802 (stdlib casing)
        self._respond(_router.route(self.server.service, "GET",
                                    self.path, b""))

    def do_POST(self):  # noqa: N802
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        res = _router.route(self.server.service, "POST", self.path, body,
                            reload_fn=getattr(self.server, "reload_fn",
                                              None))
        if isinstance(res, _router.PendingSearch):
            # each connection has its own thread here, so a blocking wait
            # on the batcher futures is the natural transport strategy
            try:
                rows = [f.result(_router.SEARCH_TIMEOUT_S)
                        for f in res.futures]
            except Exception as e:  # noqa: BLE001 — engine errors as 500
                self._respond(_router.search_error(e))
                return
            res = _router.search_response(rows)
        self._respond(res)


def make_server(service: RetrievalService, host: str = "127.0.0.1",
                port: int = 0, verbose: bool = False,
                reload_fn=None) -> ThreadingHTTPServer:
    """Bind (but do not start) the threading HTTP server; ``port=0`` picks
    a free port (``server.server_address[1]``). Call ``serve_forever()`` on
    the result, or run it from a daemon thread in tests.

    ``reload_fn(body) -> (dense_index, impact_index)`` enables
    ``POST /reload`` (zero-downtime hot swap of static artifacts):
    cli.serve wires one that re-applies its own dtype/ANN flags."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.service = service
    server.verbose = verbose
    server.reload_fn = reload_fn
    return server
