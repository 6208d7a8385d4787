"""Micro-batcher: coalesce concurrent requests into device-sized batches
(a copy of the JAX package's ``serving/batcher.py``).

A batch of queries costs the card little more than one query, and each call
pays a fixed launch + copy-back cost, so serving one query per call wastes
the device. The batcher runs ONE daemon dispatcher thread that drains
a queue: the first item opens a batch, then up to ``max_batch - 1`` more
items are collected until ``max_wait_ms`` elapses, and the whole batch runs
through ``run_batch`` — so a lone request pays at most ``max_wait_ms``
extra latency while a burst rides one program call.

Each request gets an id at ``submit``. At dispatch the batcher records
each request's ``queue_wait`` span, from its submit to the dispatch, with
attributes ``request`` and ``batch`` (``tracing.record``, while tracing is
on), and runs ``run_batch`` inside a ``run_batch`` span with attributes
``batch`` and ``rows``. Whether tracing is on or not it keeps cumulative
counters: a histogram of the queue waits (on the monotonic clock) beside
the one of each batch's ``run_batch`` time, and the counts that
``run_batch`` makes through ``tracing.count`` on its thread (the query
encoder's ``rows_real``, ``rows_launched``, ``tokens_real`` and
``tokens_launched``); and it keeps each served batch's waits and counts as
a ``micro_batch`` tally (``tracing.tally``).
"""

from __future__ import annotations

import bisect
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Sequence, Tuple

from mllm_sparse_retrieval_tpu_torch import tracing

# Prometheus-style bucket upper bounds (seconds) of the batcher's histograms
LATENCY_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                  1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Cumulative-bucket histogram of seconds, the /metrics shape (one
    writer thread)."""

    def __init__(self, bounds: Sequence[float] = LATENCY_BOUNDS):
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)     # + the +inf bucket
        self._sum = 0.0

    def observe(self, seconds: float) -> None:
        self._counts[bisect.bisect_left(self.bounds, seconds)] += 1
        self._sum += seconds

    def snapshot(self) -> Tuple[tuple, List[int], float, int]:
        """(bucket upper bounds, cumulative counts incl. +inf, sum, count)."""
        cum = list(itertools.accumulate(self._counts))
        return self.bounds, cum, self._sum, cum[-1]


class MicroBatcher:
    """Single-consumer request coalescer.

    ``run_batch(items) -> results`` is called on the dispatcher thread with
    1..max_batch items and must return exactly one result per item (an
    exception fails every future in the batch). ``submit`` is thread-safe
    and returns a ``concurrent.futures.Future``.
    """

    _SENTINEL = object()

    def __init__(
        self,
        run_batch: Callable[[List[Any]], Sequence[Any]],
        max_batch: int = 256,
        max_wait_ms: float = 4.0,
        name: str = "microbatcher",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self.n_batches = 0
        self.n_items = 0
        self.n_errors = 0
        self._ids = itertools.count()
        self._dispatched = 0
        # only the dispatcher thread writes these
        self._latency = Histogram()
        self._queue_wait = Histogram()
        self._counts: Dict[str, int] = {}
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> Future:
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._q.put((item, fut, next(self._ids), time.monotonic_ns()))
        return fut

    def close(self, timeout: float = 10.0) -> None:
        """Drain in-flight work and stop the dispatcher thread."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(self._SENTINEL)
        self._thread.join(timeout)

    def stats(self) -> Dict[str, float]:
        b, i = self.n_batches, self.n_items
        return {"batches": b, "items": i, "errors": self.n_errors,
                "mean_batch_size": (i / b) if b else 0.0}

    def latency_histogram(self):
        """(bucket upper bounds, cumulative counts incl. +inf, sum_seconds,
        count) of per-batch ``run_batch`` wall time — the /metrics shape."""
        return self._latency.snapshot()

    def queue_wait_histogram(self):
        """The same of each dispatched request's wait from ``submit`` to
        its batch's dispatch."""
        return self._queue_wait.snapshot()

    def counts(self) -> Dict[str, int]:
        """Totals of the counts ``run_batch`` made (``tracing.count``)."""
        return dict(self._counts)

    # ---- dispatcher thread --------------------------------------------------

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is self._SENTINEL:
                return
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            stop = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is self._SENTINEL:
                    stop = True
                    break
                batch.append(nxt)
            self._dispatch(batch)
            if stop:
                return

    def _dispatch(self, batch) -> None:
        # claim every future (-> RUNNING) before touching the device: a
        # caller that cancelled while queued (e.g. the asyncio front end's
        # search timeout) is dropped here, and cancel() can no longer win a
        # race against set_result below — set_result on a cancelled future
        # raises InvalidStateError, which would kill this dispatcher thread
        batch = [entry for entry in batch
                 if entry[1].set_running_or_notify_cancel()]
        if not batch:
            return
        items = [item for item, *_ in batch]
        bid = self._dispatched
        self._dispatched += 1
        t_dispatch = time.monotonic_ns()
        waits = [(t_dispatch - t_submit) / 1e9 for *_, t_submit in batch]
        for w in waits:
            self._queue_wait.observe(w)
        if tracing.on():            # the log's clock is the wall clock
            wall = time.time_ns() - time.monotonic_ns()
            for _, _, rid, t_submit in batch:
                tracing.record("queue_wait", t_submit + wall,
                               t_dispatch + wall, request=rid, batch=bid)
        counts: Dict[str, int] = {}
        t0 = time.monotonic()
        try:
            with tracing.span("run_batch", batch=bid, rows=len(items)), \
                    tracing.collect(counts):
                results = self._run_batch(items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"run_batch returned {len(results)} results for "
                    f"{len(items)} items")
        except BaseException as e:  # noqa: BLE001 — fail the futures, keep serving
            self.n_errors += 1
            for _, fut, *_ in batch:
                fut.set_exception(e)
            return
        finally:
            for name, n in counts.items():
                self._counts[name] = self._counts.get(name, 0) + n
        self._latency.observe(time.monotonic() - t0)
        self.n_batches += 1
        self.n_items += len(items)
        tracing.tally("micro_batch", waits_s=waits, **counts)
        for (_, fut, *_), res in zip(batch, results):
            fut.set_result(res)
