"""The port's one tracing module: spans, spans across threads, counts.

- ``span(name, **attrs)``: a context manager around a stage of the work.
- ``record(name, start_ns, end_ns, **attrs)``: a span whose start and end
  were taken on different threads (a request's wait in a queue).
- ``count(name, n)``: adds ``n`` to the counts of the innermost
  ``collect(into)`` block open on this thread (nothing outside one).
- ``tally(name, **values)``: keeps one unit of work's values (a served
  micro-batch's queue waits and counts) whether tracing is on or not.

Tracing is on while a ``torch.profiler`` session is active, whatever its
activities, or after ``enable()``. While it is off, ``span`` costs one flag
check and returns a shared object that does nothing, and ``record`` costs
the same check. While it is on:

- a span opens the range ``torch.profiler.record_function`` opens, of its
  name, when a profiler is active, so profiles (and the device-side spans the
  profiler derives from the range) see it;
- every span and every ``record`` goes into a bounded in-memory log
  (``LOG_CAPACITY`` entries, the oldest dropped first): name, span id, the
  id of the span open around it on its thread, the thread's name, start
  and end, attributes. Read it with ``spans()``, empty it with ``clear()``.

The log's times are ``time.time_ns()``, the clock of the profiler's
absolute event times (a trace's ``trace_start_ns()`` plus an event's
relative start), so a merged timeline can put each idle gap of the card
beside the host span open at that moment.

A profiler slows the host, so what the log holds of a profiled run is an
upper reading of host times, and of queueing it is another regime. The
tallies are the untraced twin: ``tallies(name)`` gives the last
``TALLY_CAPACITY`` tallies of a name, each marked with whether tracing was
on when it was made, so a reader can take the work that ran untraced.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

LOG_CAPACITY = 1 << 17
TALLY_CAPACITY = 1 << 14

_enabled = False
_log: "collections.deque[SpanRecord]" = collections.deque(
    maxlen=LOG_CAPACITY)
_tallies: "Dict[str, collections.deque[Tally]]" = {}
_ids = itertools.count(1)
_local = threading.local()


class SpanRecord(NamedTuple):
    """One entry of the log; times in ``time.time_ns()`` nanoseconds."""
    name: str
    id: int
    parent: Optional[int]
    thread: str
    start_ns: int
    end_ns: int
    attrs: dict


class Tally(NamedTuple):
    """One ``tally``: its values, and whether tracing was on."""
    traced: bool
    values: dict


def on() -> bool:
    """Whether tracing is on: ``enable()`` was called, or a profiler runs.
    Callers check it before work only tracing needs (the batcher's
    ``queue_wait`` records)."""
    return _enabled or _profiler._is_profiler_enabled


def enable() -> None:
    """Turn tracing on with no profiler running (spans log, open no
    profiler range)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def spans() -> List[SpanRecord]:
    """The log, oldest first."""
    return list(_log)


def clear() -> None:
    """Empty the log and the tallies."""
    _log.clear()
    _tallies.clear()


class _Off:
    """What ``span`` returns while tracing is off: enters and exits, doing
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


_range_ops_cache: Optional[tuple] = None


def _range_ops() -> tuple:
    """The two operators behind ``torch.profiler.record_function``, looked
    up once (the first lookup takes a millisecond, which would otherwise
    fall inside the first range)."""
    global _range_ops_cache
    if _range_ops_cache is None:
        import torch
        ops = torch.ops.profiler
        _range_ops_cache = (ops._record_function_enter_new,
                            ops._record_function_exit._RecordFunction)
    return _range_ops_cache


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "_range",
                 "_exit")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self._range = None
        if _profiler._is_profiler_enabled:
            enter, self._exit = _range_ops()
            self.start_ns = time.time_ns()
            self._range = enter(self.name, None)
        else:
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._exit(self._range)
        end = time.time_ns()
        _stack().pop()
        _log.append(SpanRecord(self.name, self.id, self.parent,
                               threading.current_thread().name,
                               self.start_ns, end, self.attrs))
        return False


def span(name: str, **attrs):
    """``with span("tokenize"):`` around a stage of the work."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Log a span timed by the caller on any thread (``time.time_ns()``),
    with no parent and no profiler range."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    _log.append(SpanRecord(name, next(_ids), None,
                           threading.current_thread().name,
                           int(start_ns), int(end_ns), attrs))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``name`` in the dict of the innermost ``collect`` open
    on this thread."""
    sink = getattr(_local, "sink", None)
    if sink is not None:
        sink[name] = sink.get(name, 0) + n


class collect:
    """``with collect(counts):`` gathers this thread's ``count`` calls
    inside the block into the dict ``counts`` (blocks nest; the innermost
    takes them)."""

    __slots__ = ("_into", "_prev")

    def __init__(self, into: Dict[str, int]):
        self._into = into

    def __enter__(self):
        self._prev = getattr(_local, "sink", None)
        _local.sink = self._into
        return self._into

    def __exit__(self, exc_type, exc, tb):
        _local.sink = self._prev
        return False


def tally(name: str, **values) -> None:
    """Keep ``values`` as the newest tally of ``name``, marked with whether
    tracing is on (a deque append: it costs the same on and off)."""
    ring = _tallies.get(name)
    if ring is None:
        ring = _tallies.setdefault(
            name, collections.deque(maxlen=TALLY_CAPACITY))
    ring.append(Tally(_enabled or _profiler._is_profiler_enabled, values))


def tallies(name: str) -> List[Tally]:
    """The kept tallies of ``name``, oldest first."""
    return list(_tallies.get(name, ()))
