"""Micro-batcher: coalesce concurrent requests into device-sized batches
(a copy of the JAX package's ``serving/batcher.py``).

A batch of queries costs the card little more than one query, and each call
pays a fixed launch + copy-back cost, so serving one query per call wastes
the device. The batcher runs ONE daemon dispatcher thread that drains
a queue: the first item opens a batch, then up to ``max_batch - 1`` more
items are collected until ``max_wait_ms`` elapses, and the whole batch runs
through ``run_batch`` — so a lone request pays at most ``max_wait_ms``
extra latency while a burst rides one program call.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Sequence


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
        # per-batch run_batch latency histogram (Prometheus-style
        # cumulative buckets; only the dispatcher thread writes)
        self.latency_bounds = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                               0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
        self._lat_counts = [0] * (len(self.latency_bounds) + 1)  # +inf
        self._lat_sum = 0.0
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> Future:
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._q.put((item, fut))
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
        cum = []
        total = 0
        for c in self._lat_counts:
            total += c
            cum.append(total)
        return self.latency_bounds, cum, self._lat_sum, total

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
        batch = [(item, fut) for item, fut in batch
                 if fut.set_running_or_notify_cancel()]
        if not batch:
            return
        items = [item for item, _ in batch]
        t0 = time.monotonic()
        try:
            results = self._run_batch(items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"run_batch returned {len(results)} results for "
                    f"{len(items)} items")
        except BaseException as e:  # noqa: BLE001 — fail the futures, keep serving
            self.n_errors += 1
            for _, fut in batch:
                fut.set_exception(e)
            return
        dt = time.monotonic() - t0
        slot = 0
        for bound in self.latency_bounds:
            if dt <= bound:
                break
            slot += 1
        self._lat_counts[slot] += 1
        self._lat_sum += dt
        self.n_batches += 1
        self.n_items += len(items)
        for (_, fut), res in zip(batch, results):
            fut.set_result(res)
