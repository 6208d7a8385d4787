"""Bounded dispatch-ahead pipeline and a host prefetch thread (a copy of
the JAX package's ``ops/stream.py``).

``pipeline_dispatch`` keeps up to ``lookahead`` device programs in flight
ahead of the consumer, so batch r+1's upload and compute overlap batch r's
copy back and host post-processing; ``prefetch_thread`` runs host
preparation (tokenization, image preprocessing) on a daemon thread one or
more items ahead. CUDA work is asynchronous, so the same pattern holds on
the card: a dispatch enqueues kernels and returns, a resolve waits on its
copy to the host.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")
D = TypeVar("D")
R = TypeVar("R")

_POLL_S = 0.1   # bounded waits, so a stopped consumer frees the worker


def pipeline_dispatch(
    items: Iterable[T],
    dispatch: Callable[[T], D],
    resolve: Callable[[D], Optional[R]],
    lookahead: int = 2,
) -> Iterator[R]:
    """Run ``dispatch`` up to ``lookahead`` items ahead of ``resolve``.

    ``dispatch`` enqueues device work without a host sync and returns a
    handle; ``resolve`` waits on a handle and may return a result to yield
    (``None`` results are swallowed: drain with ``deque(..., maxlen=0)``
    when only the side effects matter).
    """
    pending: "collections.deque[D]" = collections.deque()
    depth = max(lookahead, 1)
    for item in items:
        while len(pending) >= depth:
            out = resolve(pending.popleft())
            if out is not None:
                yield out
        pending.append(dispatch(item))
    while pending:
        out = resolve(pending.popleft())
        if out is not None:
            yield out


def prefetch_thread(items: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``items`` on a daemon thread, ``depth`` items ahead.

    Order is kept; an exception of the producer re-raises at the point of
    consumption; abandoning the iterator (break, garbage collection) stops
    the worker at its next bounded wait.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            put(e)
            return
        put(end)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():  # release queued references
            try:
                q.get_nowait()
            except queue.Empty:
                break
