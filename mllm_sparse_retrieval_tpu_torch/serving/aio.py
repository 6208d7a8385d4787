"""Event-loop HTTP front end for :class:`RetrievalService`, stdlib asyncio
(a copy of the JAX package's ``serving/aio.py``).

Same endpoint protocol as ``serving/http.py`` (routing shared through
``serving/router.py``), another concurrency model: one event-loop thread
multiplexes every connection instead of one handler thread per
connection. Request framing is a flat buffer scan, responses are written
in arrival order per connection (HTTP/1.1 keep-alive and pipelining), and
the per-request work is one JSON decode, a micro-batcher submit and one
JSON encode.

Division of labor per request class:

- ``POST /search`` and every GET run inline on the loop: submission to the
  micro-batcher is non-blocking (validate, queue put), and the batcher
  futures are awaited through ``asyncio.wrap_future``; the dispatcher
  thread resolves them.
- Mutations (``/documents``, ``/documents/delete``, ``/compact``,
  ``/save``), ``/reload`` and ``/filters`` registration run on a small
  thread pool: they hold engine locks or rebuild filter masks, and a
  blocking call on the loop would stall every in-flight search. So does a
  search carrying ``image_b64`` (a 400 in the port: no image decoder yet,
  ROADMAP Queue 1 #8b).

The server object mirrors the stdlib server surface (``server_address``,
``serve_forever()``, ``shutdown()``, ``server_close()``), so ``cli.serve``
and the tests swap front ends with one flag.
"""

from __future__ import annotations

import asyncio
import socket
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import partial

from mllm_sparse_retrieval_tpu_torch.serving import router as _router
from mllm_sparse_retrieval_tpu_torch.serving.service import RetrievalService

_MAX_HEAD = 64 * 1024            # request line + headers
_MAX_BODY = 1 << 30              # 1 GiB — image batches stay far below

_STATUS = {
    200: b"200 OK",
    400: b"400 Bad Request",
    404: b"404 Not Found",
    413: b"413 Payload Too Large",
    431: b"431 Request Header Fields Too Large",
    500: b"500 Internal Server Error",
}


def _frame(res: _router.Response, close: bool) -> bytes:
    status = _STATUS.get(res.status) or (
        str(res.status).encode() + b" Status")
    return (b"HTTP/1.1 " + status
            + b"\r\nContent-Type: " + res.content_type.encode()
            + b"\r\nContent-Length: " + str(len(res.body)).encode()
            + b"\r\nConnection: " + (b"close" if close else b"keep-alive")
            + b"\r\n\r\n" + res.body)


class _Conn(asyncio.Protocol):
    """One client connection: parse -> handler task -> ordered writer.

    Handler tasks run concurrently (many searches of one connection can
    share a micro-batch), but responses must leave in request order —
    ``_write_loop`` awaits the per-request tasks FIFO, which is what makes
    pipelined clients correct."""

    __slots__ = ("srv", "transport", "buf", "head", "q", "writer")

    def __init__(self, srv: "AioHTTPServer"):
        self.srv = srv
        self.transport = None
        self.buf = bytearray()
        self.head = None             # (method, path, clen, close) mid-body
        self.q: asyncio.Queue = asyncio.Queue()
        self.writer = None

    def connection_made(self, transport) -> None:
        self.transport = transport
        sock = transport.get_extra_info("socket")
        if sock is not None:
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        self.writer = asyncio.get_running_loop().create_task(
            self._write_loop())

    def connection_lost(self, exc) -> None:
        if self.writer is not None:
            self.writer.cancel()

    # ---- parse ----------------------------------------------------------

    def data_received(self, data: bytes) -> None:
        self.buf += data
        while True:
            if self.head is None:
                end = self.buf.find(b"\r\n\r\n")
                if end < 0:
                    if len(self.buf) > _MAX_HEAD:
                        self._reject(431, "request head too large")
                    return
                try:
                    self.head = self._parse_head(bytes(self.buf[:end]))
                except ValueError as e:
                    self._reject(400, str(e))
                    return
                del self.buf[:end + 4]
                if self.head[2] > _MAX_BODY:
                    self._reject(413, "request body too large")
                    return
            method, path, clen, close = self.head
            if len(self.buf) < clen:
                return
            body = bytes(self.buf[:clen])
            del self.buf[:clen]
            self.head = None
            if self.srv.verbose:
                print(f"aio-http: {method} {path} ({clen}B)",
                      file=sys.stderr)
            task = asyncio.get_running_loop().create_task(
                self._handle(method, path, body))
            self.q.put_nowait((task, close))
            if close:
                return                      # drop any pipelined leftovers

    @staticmethod
    def _parse_head(head: bytes):
        lines = head.split(b"\r\n")
        parts = lines[0].split(b" ")
        if len(parts) != 3 or not parts[2].startswith(b"HTTP/1."):
            raise ValueError("malformed request line")
        method = parts[0].decode("latin-1")
        path = parts[1].decode("latin-1")
        clen = 0
        close = parts[2] == b"HTTP/1.0"     # 1.0 default: no keep-alive
        for ln in lines[1:]:
            key, _, val = ln.partition(b":")
            key = key.lower()
            if key == b"content-length":
                try:
                    clen = int(val)
                except ValueError:
                    raise ValueError("bad Content-Length") from None
            elif key == b"connection":
                tok = val.strip().lower()
                close = tok == b"close" or (close
                                            and tok != b"keep-alive")
        return method, path, clen, close

    def _reject(self, status: int, msg: str) -> None:
        """Protocol-level fault: answer (in order) and close."""
        res = _router.json_response(status, {"error": msg})

        async def _done():
            return res
        self.q.put_nowait((asyncio.get_running_loop().create_task(_done()),
                           True))
        self.buf.clear()
        self.head = None

    # ---- handle + write ---------------------------------------------------

    async def _handle(self, method: str, path: str,
                      body: bytes) -> _router.Response:
        srv = self.srv
        if method == "POST" and (path != "/search"
                                 or b"image_b64" in body):
            # blocking endpoint (engine locks, artifact IO): keep the loop
            # free for in-flight searches
            res = await asyncio.get_running_loop().run_in_executor(
                srv._pool, partial(_router.route, srv.service, method,
                                   path, body, reload_fn=srv.reload_fn))
        else:
            res = _router.route(srv.service, method, path, body,
                                reload_fn=srv.reload_fn)
        if isinstance(res, _router.PendingSearch):
            try:
                rows = await asyncio.wait_for(
                    asyncio.gather(*(asyncio.wrap_future(f)
                                     for f in res.futures)),
                    _router.SEARCH_TIMEOUT_S)
            except (Exception, asyncio.CancelledError) as e:
                if isinstance(e, asyncio.CancelledError):
                    raise
                return _router.search_error(e)
            return _router.search_response(rows)
        return res

    async def _write_loop(self) -> None:
        try:
            while True:
                task, close = await self.q.get()
                try:
                    res = await task
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — never drop the
                    # connection without an answer
                    res = _router.search_error(e)
                self.transport.write(_frame(res, close))
                if close:
                    self.transport.close()
                    return
        except asyncio.CancelledError:
            pass


class AioHTTPServer:
    """Stdlib-server-shaped wrapper around one asyncio event loop.

    ``make_server`` binds the socket immediately (so ``server_address`` is
    final before any thread starts); ``serve_forever()`` runs the loop on
    the calling thread; ``shutdown()`` (any thread) stops it and blocks
    until the loop exits; ``server_close()`` releases the socket, pending
    tasks, and the worker pool."""

    def __init__(self, service: RetrievalService, host: str, port: int,
                 verbose: bool = False, reload_fn=None):
        self.service = service
        self.verbose = verbose
        self.reload_fn = reload_fn
        self._pool = ThreadPoolExecutor(max_workers=4,
                                        thread_name_prefix="aio-http")
        self._loop = asyncio.new_event_loop()
        self._server = self._loop.run_until_complete(
            self._loop.create_server(lambda: _Conn(self), host, port))
        self.server_address = self._server.sockets[0].getsockname()
        self._stopped = threading.Event()
        self._serving = False

    def serve_forever(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._serving = True
        try:
            self._loop.run_forever()
        finally:
            self._stopped.set()

    def shutdown(self) -> None:
        if not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._serving:
            self._stopped.wait(10.0)

    def server_close(self) -> None:
        if self._loop.is_closed():
            return
        if self._loop.is_running():      # shutdown() not called first
            self.shutdown()
        self._server.close()
        self._loop.run_until_complete(self._server.wait_closed())
        pending = asyncio.all_tasks(self._loop)
        for t in pending:
            t.cancel()
        if pending:
            self._loop.run_until_complete(
                asyncio.gather(*pending, return_exceptions=True))
        self._loop.close()
        self._pool.shutdown(wait=False)


def make_server(service: RetrievalService, host: str = "127.0.0.1",
                port: int = 0, verbose: bool = False,
                reload_fn=None) -> AioHTTPServer:
    """Bind (but do not start) the asyncio HTTP server; same contract as
    ``serving.http.make_server`` — ``port=0`` picks a free port, call
    ``serve_forever()`` (blocking) or run it from a daemon thread."""
    return AioHTTPServer(service, host, port, verbose=verbose,
                         reload_fn=reload_fn)
