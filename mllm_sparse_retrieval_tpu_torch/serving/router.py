"""Transport-agnostic request routing for the serving front ends (a copy
of the JAX package's ``serving/router.py``: the same endpoints, bodies and
status codes).

Both HTTP servers, the stdlib threading one (``serving/http.py``) and the
asyncio event-loop one (``serving/aio.py``), speak the same endpoint
protocol over the same :class:`RetrievalService`. This module holds that
protocol once: ``route()`` maps (method, path, body bytes) to either a
finished :class:`Response` or, for ``POST /search``, a
:class:`PendingSearch` carrying the micro-batcher futures; the transport
decides how to wait (a blocking ``Future.result`` on a handler thread, or
``await`` on the event loop).

Endpoint semantics (bodies, status codes, error classes) are documented in
``serving/http.py``. ``image_b64`` queries are decoded by the port's own
decoder (``data/imageio.py``, JPEG and PNG bit-equal to Pillow), not by
Pillow: a payload that is not valid base64, not a JPEG or PNG, or
truncated is a 400, as an undecodable payload is in the JAX package; a
GIF, WebP or BMP payload, which Pillow decodes, is a 400 here too.

``GET /metrics`` (``prometheus_metrics``) carries the JAX package's series
and, from the micro-batcher's counters, the port's own: the
``retrieval_queue_wait_seconds`` histogram (submit to dispatch, one
observation a dispatched request, built with the latency histogram's
helper) and ``retrieval_encoded_{rows,tokens}_{real,launched}_total``, the
query rows and prompt tokens that text encodes carried against those they
launched (every micro-batch pads to the service's ``device_batch`` rows
and to the encoder's padded length).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

JSON_CT = "application/json"


@dataclass
class Response:
    """A finished HTTP response: the transport only frames and writes it."""
    status: int
    content_type: str
    body: bytes


@dataclass
class PendingSearch:
    """``POST /search`` accepted: one micro-batcher future per query, in
    request order. The transport waits its own way, then formats with
    :func:`search_response` (or :func:`search_error` on failure)."""
    futures: List


def json_response(status: int, payload: dict) -> Response:
    return Response(status, JSON_CT, json.dumps(payload).encode())


def search_response(rows) -> Response:
    """Resolved per-query result rows -> the ``/search`` 200 body."""
    return json_response(200, {"results": [
        [[doc, float(score)] for doc, score in row] for row in rows]})


def search_error(exc: BaseException) -> Response:
    """An engine/batch failure surfaced by a search future -> structured
    500 (same policy as every endpoint: a JSON error beats a dropped
    connection)."""
    return json_response(500, {"error": str(exc)})


SEARCH_TIMEOUT_S = 120.0

# client-fault exception classes -> 400 (engine faults stay 500)
_CLIENT_ERRORS = (ValueError, KeyError, TypeError, json.JSONDecodeError)


def decode_image(b64: Optional[str]):
    """base64 image file bytes -> raw [H, W, 3] float32 in [0, 1] at the
    original resolution (the encoder owns family-specific resize/tiling).
    Invalid base64 and an image the decoder refuses raise ``ValueError``
    (a 400)."""
    if b64 is None:
        return None
    import base64

    import numpy as np

    from mllm_sparse_retrieval_tpu_torch.data.imageio import (
        decode_image_bytes)

    img = decode_image_bytes(base64.b64decode(b64), "image_b64")
    return np.asarray(img, np.float32) / 255.0


def normalize_terms(raw, int_keyed: bool):
    if raw is None:
        return None
    if isinstance(raw, dict):
        pairs = raw.items()
    else:
        pairs = ((k, w) for k, w in raw)
    if int_keyed:
        return {int(k): float(w) for k, w in pairs}
    return {str(k): float(w) for k, w in pairs}


PADDING_COUNTS = ("rows_real", "rows_launched", "tokens_real",
                  "tokens_launched")


def _histogram_lines(name: str, snapshot) -> List[str]:
    bounds, cum, total, count = snapshot
    lines = [f"# TYPE {name} histogram"]
    for bound, c in zip(bounds, cum[:-1]):
        lines.append(f'{name}_bucket{{le="{bound:g}"}} {c}')
    lines.append(f'{name}_bucket{{le="+Inf"}} {cum[-1]}')
    lines.append(f"{name}_sum {total:.6f}")
    lines.append(f"{name}_count {count}")
    return lines


def prometheus_metrics(svc) -> str:
    """Prometheus text exposition (0.0.4) of the service counters: request
    / batch / error totals, coalescing ratio, per-batch latency histogram,
    per-request queue-wait histogram, the encoded rows and tokens real and
    launched (padding included), and (live services) per-engine
    doc/segment gauges."""
    s = svc.stats()
    lines = [
        "# TYPE retrieval_requests_total counter",
        f"retrieval_requests_total {int(s['items'])}",
        "# TYPE retrieval_batches_total counter",
        f"retrieval_batches_total {int(s['batches'])}",
        "# TYPE retrieval_batch_errors_total counter",
        f"retrieval_batch_errors_total {int(s['errors'])}",
        "# TYPE retrieval_mean_batch_size gauge",
        f"retrieval_mean_batch_size {s['mean_batch_size']:.6g}",
        f'retrieval_info{{mode="{svc.mode}",live="{int(svc.live)}"}} 1',
    ]
    for engine in ("dense", "sparse"):
        if f"{engine}_docs" in s:
            lines += [
                f'retrieval_live_docs{{engine="{engine}"}} '
                f'{int(s[engine + "_docs"])}',
                f'retrieval_live_segments{{engine="{engine}"}} '
                f'{int(s[engine + "_segments"])}',
            ]
    lines += _histogram_lines("retrieval_batch_latency_seconds",
                              svc._batcher.latency_histogram())
    lines += _histogram_lines("retrieval_queue_wait_seconds",
                              svc._batcher.queue_wait_histogram())
    counts = svc._batcher.counts()
    for name in PADDING_COUNTS:
        lines += [f"# TYPE retrieval_encoded_{name}_total counter",
                  f"retrieval_encoded_{name}_total {counts.get(name, 0)}"]
    return "\n".join(lines) + "\n"


def route(svc, method: str, path: str, body: bytes,
          reload_fn=None):
    """One request -> :class:`Response`, or :class:`PendingSearch` for
    ``POST /search``. Never raises for client input: malformed bodies and
    validation failures come back as 400 Responses; engine/loader faults
    as 500. ``body`` is the raw request body (GETs pass ``b""``)."""
    if method == "GET":
        return _route_get(svc, path)
    if method != "POST":
        return json_response(404, {"error": f"unknown method {method}"})
    if path == "/search":
        return _route_search(svc, body)
    if path in ("/documents", "/documents/delete", "/compact", "/save"):
        return _route_mutate(svc, path, body)
    if path == "/reload":
        return _route_reload(svc, body, reload_fn)
    if path == "/filters":
        return _route_register_filter(svc, body)
    return json_response(404, {"error": f"unknown path {path}"})


def _route_get(svc, path: str) -> Response:
    if path == "/healthz":
        return json_response(200, {"ok": True, "mode": svc.mode})
    if path == "/stats":
        return json_response(200, svc.stats())
    if path == "/filters":
        return json_response(200, {"filters": svc.filter_names})
    if path == "/metrics":
        return Response(200, "text/plain; version=0.0.4; charset=utf-8",
                        prometheus_metrics(svc).encode())
    return json_response(404, {"error": f"unknown path {path}"})


def _parse_body(body: bytes) -> dict:
    return json.loads(body or b"{}")


def _route_search(svc, body: bytes):
    try:
        parsed = _parse_body(body)
        queries = parsed["queries"] if "queries" in parsed else [parsed]
        int_keyed = (svc.impact_index is not None
                     and svc.impact_index.int_keyed)
        futures = [
            svc.search_async(
                terms=normalize_terms(q.get("terms"), int_keyed),
                dense=q.get("dense"),
                depth=q.get("depth"),
                text=q.get("text"),
                image=decode_image(q.get("image_b64")),
                filter=q.get("filter"))
            for q in queries
        ]
    except _CLIENT_ERRORS as e:
        return json_response(400, {"error": str(e)})
    return PendingSearch(futures)


def _route_mutate(svc, path: str, body: bytes) -> Response:
    """Live-index update endpoints. Term keys arrive as JSON strings; they
    are coerced to token ids iff the sparse engine is int-keyed (same rule
    as /search)."""
    try:
        parsed = _parse_body(body)
        if path == "/compact":
            return json_response(200, {"ok": True, **svc.compact()})
        if path == "/save":
            # body may carry {"directory": ...}; default live_state_dir
            return json_response(200, {
                "ok": True,
                "directory": svc.save_live(parsed.get("directory"))})
        if path == "/documents/delete":
            ids = parsed["ids"]
            if not isinstance(ids, list):
                raise ValueError("'ids' must be a list")
            return json_response(200, {"deleted": svc.delete_documents(
                [str(i) for i in ids])})
        docs = parsed["documents"]
        if not isinstance(docs, list):
            raise ValueError("'documents' must be a list")
        int_keyed = (svc.impact_index is not None
                     and svc.impact_index.int_keyed)
        prepared = [
            {**d, "terms": normalize_terms(d.get("terms"), int_keyed)}
            for d in docs]
        return json_response(200, {"added": svc.add_documents(prepared)})
    except _CLIENT_ERRORS as e:
        return json_response(400, {"error": str(e)})


def _route_reload(svc, body: bytes, reload_fn) -> Response:
    try:
        if reload_fn is None:
            raise ValueError(
                "no reload loader configured (cli.serve wires one for "
                "static artifact serving)")
        parsed = _parse_body(body)
        dense, impact = reload_fn(parsed)
        svc.reload_indexes(dense, impact)
        return json_response(200, {
            "ok": True,
            "dense_docs": None if dense is None else dense.size,
            "sparse_docs": None if impact is None else impact.num_docs,
            "filters_rebuilt": svc.filter_names})
    except _CLIENT_ERRORS as e:
        return json_response(400, {"error": str(e)})
    except Exception as e:  # noqa: BLE001 — corrupt artifacts, loader/
        # engine faults: a structured 500 beats a dropped connection
        # (same policy as /search)
        return json_response(500, {"error": str(e)})


def _route_register_filter(svc, body: bytes) -> Response:
    try:
        parsed = _parse_body(body)
        if not isinstance(parsed.get("ids"), (list, tuple)):
            # a bare string would iterate character-by-character — a
            # silently wrong tenant scope, not an error
            raise ValueError("'ids' must be a list")
        n = svc.register_filter(parsed["name"],
                                [str(i) for i in parsed["ids"]],
                                parsed.get("mode", "allow"))
        return json_response(200, {"name": str(parsed["name"]),
                                   "allowed": n})
    except _CLIENT_ERRORS as e:
        return json_response(400, {"error": str(e)})
