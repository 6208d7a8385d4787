"""A profiled slice of a run: the device's operations and the program's
ranges from ``torch.profiler``, and what the readers take from them.

The slice runs with CPU and CUDA activities, every thread's ranges
included (the service encodes on its batcher thread). A range's device
time is that of the kernels that start inside its device-side span (the
port's ctypes kernels are linked to no CPU op, but run inside the spans of
the ranges around them), as ``chip_smoke.profiled`` reads it.
"""

from __future__ import annotations

import bisect
import heapq
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple


@dataclass
class Trace:
    window_s: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    cpu: List[Tuple[str, float, float, bool]] = field(default_factory=list)
    t0_us: float = 0.0

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def kernel_s(self, substr: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds ``substr``."""
        hits = [e - s for n, s, e in self.kernels if substr in n]
        return sum(hits) / 1e6, len(hits)

    def span_s(self, name: str) -> Tuple[float, int]:
        """(device seconds of kernels starting inside ``name``'s spans,
        number of such spans)."""
        spans = sorted((s, e) for n, s, e in self.spans if n == name)
        if not spans:
            return 0.0, 0
        starts = [s for s, _ in spans]
        total = 0.0
        for _, ks, ke in self.kernels:
            j = bisect.bisect_right(starts, ks) - 1
            if j >= 0 and ks < spans[j][1]:
                total += ke - ks
        return total / 1e6, len(spans)

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle time within the slice summed by what the host
        was doing at each gap's middle: the innermost range of the
        program there, else the innermost operator, else ``host``."""
        ks = sorted((s, e) for _, s, e in self.kernels)
        end_us = self.t0_us + self.window_s * 1e6
        gaps, cur = [], self.t0_us
        for s, e in ks:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if end_us > cur:
            gaps.append((cur, end_us))
        ranges = sorted(self.cpu, key=lambda c: c[1])
        heaps = {True: [], False: []}     # (duration, end, name) by kind
        by: Dict[str, float] = {}
        i = 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (s + e) / 2
            while i < len(ranges) and ranges[i][1] <= mid:
                name, cs, ce, annotation = ranges[i]
                heapq.heappush(heaps[annotation], (ce - cs, ce, name))
                i += 1
            found = {}
            for kind, heap in heaps.items():
                while heap and heap[0][1] < mid:
                    heapq.heappop(heap)
                found[kind] = heap[0][2] if heap else None
            key = found[True] or found[False] or "host"
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]


def profiled(fn: Callable[[], object], sync: Callable[[], None],
             host: bool = True):
    """``(fn(), Trace)`` of one call of ``fn`` under the profiler; ``sync``
    ends the slice's device work. ``host=False`` records the card alone
    (a training step's hundreds of thousands of host operators would slow
    it several times over): no ranges, and idle time is labelled
    ``host``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kwargs = {}
    try:
        from torch.profiler import _ExperimentalConfig
        kwargs["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    activities = [ProfilerActivity.CUDA]
    if host or not torch.cuda.is_available():   # no card: the CPU tests
        activities.insert(0, ProfilerActivity.CPU)
    else:
        kwargs = {}
    with profile(activities=activities, **kwargs) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window = time.perf_counter() - t0
    tr = Trace(window_s=window)
    starts = []
    for evt in prof.events():
        s, e = evt.time_range.start, evt.time_range.end
        annotation = bool(getattr(evt, "is_user_annotation", False))
        if evt.device_type == DeviceType.CUDA:
            if annotation:
                tr.spans.append((evt.name, s, e))
            else:
                tr.kernels.append((evt.name, s, e))
        else:
            tr.cpu.append((evt.name, s, e, annotation))
            starts.append(s)
    tr.t0_us = min(starts) if starts else min(
        (k[1] for k in tr.kernels), default=0.0)
    if not host and tr.kernels:
        # no host events: the slice's window ends at its last kernel
        tr.window_s = max(window, (max(k[2] for k in tr.kernels)
                                   - tr.t0_us) / 1e6)
    return out, tr
