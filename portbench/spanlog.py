"""The program's span log and tallies, as the per-layer readers take them.

- The log: the entries of ``mllm_sparse_retrieval_tpu_torch.tracing.
  spans()`` (name, ``start_ns``, ``end_ns``, ``attrs``). Tracing is on
  while a profiler runs, and a kind runs one profiled slice, so in a run
  the log holds that slice alone, its host times as the profiler slowed
  them.
- The tallies: ``tracing.tallies(name)``, the program's always-on record
  of recent units of work (a served micro-batch's queue waits and counts),
  each marked with whether tracing was on. A kind's unprofiled window ends
  before its profiled slice begins, so the window's are the last ones
  made with tracing off.

A program without the tracing module gives an empty log and no tallies,
and the readers find nothing in them."""

from __future__ import annotations

from typing import List, Optional


def log() -> list:
    try:
        from mllm_sparse_retrieval_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def tallies(name: str) -> list:
    try:
        from mllm_sparse_retrieval_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.tallies(name)


def window(n: Optional[int], name: str,
           entries: Optional[list] = None) -> List[dict]:
    """The values of the last ``n`` tallies ``name`` made with tracing off:
    the ``n`` units of work of a kind's window. ``entries`` None reads the
    program's tallies."""
    if not n:
        return []
    untraced = [t.values for t in (tallies(name) if entries is None
                                   else entries) if not t.traced]
    return untraced[-n:]


def named(entries: Optional[list], name: str) -> List:
    """The entries called ``name``; ``entries`` None reads the program's
    log."""
    return [s for s in (log() if entries is None else entries)
            if s.name == name]


def host_ms(entries) -> float:
    """Milliseconds of host time the entries cover, summed."""
    return sum(s.end_ns - s.start_ns for s in entries) / 1e6
