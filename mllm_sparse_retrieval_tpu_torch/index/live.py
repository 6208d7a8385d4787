"""Live (incrementally updatable) indexes: segments and tombstones (the
JAX package's ``index/live.py``).

Documents can be added and deleted while the index serves queries, with
Lucene's segments-and-tombstones design:

- **Segments.** The big immutable *base* index keeps its device matrices.
  Each ``add_documents`` call becomes a small immutable *delta* segment; a
  search queries every segment and merges the per-segment top-k on the
  host (``_merge_rows``; the candidate lists are ``depth`` per segment).
- **Bucketed shapes.** Dense deltas are zero-padded to power-of-two row
  *buckets*; the pad rows carry ``_PAD_ID`` and are dropped at the merge.
  Sparse deltas search with the ``matmul`` backend and the base with the
  caller's, the TAAT kernel on the card: the JAX package's routing, whose
  reason there (a Pallas compile per delta vocabulary) does not hold on the
  card; changing it is a speed question for later.
- **Tombstones.** ``delete_documents`` marks ids in the segments that hold
  them; matching rows are dropped at the merge, with each segment's fetch
  depth raised by its tombstone count (``_fetch_depth``, quantized to
  powers of two). ``add_documents`` has Lucene ``updateDocument``
  semantics: it first tombstones the ids in every existing segment.
- **Compaction.** ``compact()`` merges all segments minus tombstones into a
  fresh base; past ``max_delta_segments`` deltas a tiered merge of the
  newest deltas runs inline, or on a background compactor thread with
  ``background_compaction=True``, when writers past
  ``max_stalled_segments`` stall (``_stall_writes``). ``close()`` stops
  that thread and the delta search pool.

Thread safety: mutators take the instance lock and swap immutable snapshot
tuples; searches read one snapshot and never block updates. The delta
searches of ``_search_segments`` run on a small thread pool on the device's
default stream, so their kernels stay in stream order with every other
thread's. The host merge of list-shaped rows is the C helper
``hostops.merge_topk_rows``, with the same results as the Python body
(``_merge_rows_python``).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

import torch

from mllm_sparse_retrieval_tpu_torch import hostops as _hostops
from mllm_sparse_retrieval_tpu_torch.index.arena import (
    _DTYPE_NAMES, dense_dtype)
from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex

# Dense delta pad rows carry this lookup id; pads score real inner products
# (0.0 can outrank negatives) so they must be filtered at merge, never served.
_PAD_ID = "\x00__pad__"


def _bucket(n: int, minimum: int) -> int:
    """Smallest power of two >= max(n, minimum) — the dense-delta row count
    is padded to this, so deltas come in few shapes."""
    b = max(int(minimum), 1)
    while b < n:
        b *= 2
    return b


def _fetch_depth(depth: int, extra: int, size: int) -> int:
    """Per-segment fetch depth: the requested depth plus headroom for rows
    the merge will drop (tombstones, pad rows), quantized to depth + a power
    of two so distinct fetch shapes stay O(log segment size)."""
    if extra <= 0:
        return min(depth, size) if size else depth
    pow2 = 1
    while pow2 < extra:
        pow2 *= 2
    return min(depth + pow2, size)


@dataclass
class _Segment:
    """One immutable searchable unit + the ids deleted from it since build."""
    index: object                      # DenseFlatIndex or ImpactIndex
    id_set: Set[str]                   # live doc ids at build time
    tombstones: Set[str] = field(default_factory=set)
    n_pad: int = 0                     # dense bucket pad rows (share _PAD_ID)

    @property
    def drop_count(self) -> int:
        return len(self.tombstones) + self.n_pad


def _merge_rows(
    per_segment: Sequence[Tuple[Sequence, Sequence]],  # [(scores, ids), ...]
    segments: Sequence[_Segment],
    depth: int,
) -> Tuple[List[List[float]], List[List[str]]]:
    """Merge per-segment ranked rows into one ranked row per query.

    Candidates concatenate in segment order and sort stably by descending
    score, so equal scores rank older-segment-first — deterministic, and ids
    never duplicate because adds tombstone their id everywhere else.

    List-shaped rows take the C merge (``hostops.merge_topk_rows``); other
    rows, or rows it refuses, take the Python body.
    """
    # snapshot the tombstone set objects once (deletes replace, never
    # mutate, them) so both paths see one consistent view per merge
    tombs = [seg.tombstones for seg in segments]
    pads = [1 if seg.n_pad else 0 for seg in segments]
    if all(type(p[0]) is list and type(p[1]) is list for p in per_segment):
        try:
            return _hostops.get().merge_topk_rows(
                [p[0] for p in per_segment], [p[1] for p in per_segment],
                tombs, pads, _PAD_ID, int(depth))
        except (TypeError, ValueError):
            pass
    return _merge_rows_python(per_segment, tombs, pads, depth)


def _merge_rows_python(per_segment, tombs, pads, depth: int
                       ) -> Tuple[List[List[float]], List[List[str]]]:
    """``_merge_rows``' Python body, the C merge's semantic reference."""
    b = len(per_segment[0][0])
    out_s: List[List[float]] = []
    out_i: List[List[str]] = []
    for q in range(b):
        cand_s: List[float] = []
        cand_i: List[str] = []
        for (seg_scores, seg_ids), tomb, pad in zip(per_segment, tombs,
                                                    pads):
            for s, i in zip(seg_scores[q], seg_ids[q]):
                if i in tomb or (pad and i == _PAD_ID):
                    continue
                cand_s.append(float(s))
                cand_i.append(i)
        if len(cand_i) > 1:
            order = sorted(range(len(cand_s)), key=lambda j: -cand_s[j])
            cand_s = [cand_s[j] for j in order]
            cand_i = [cand_i[j] for j in order]
        out_s.append(cand_s[:depth])
        out_i.append(cand_i[:depth])
    return out_s, out_i


class _LiveBase:
    """Shared segment bookkeeping for the dense and sparse live indexes.
    Segments built here (deltas, merges) live on ``device``."""

    live_capable = True      # serving.service protocol flag (also on the
                             # arena classes, index/arena.py)

    def __init__(self, max_delta_segments: int,
                 background_compaction: bool = False,
                 max_stalled_segments: Optional[int] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._segments: Tuple[_Segment, ...] = ()
        self.max_delta_segments = int(max_delta_segments)
        # write-stall bound (Lucene's too-many-merges stall): background
        # writers block once the delta count exceeds this, so sustained
        # writes can never push search latency unboundedly ahead of the
        # compactor
        self.max_stalled_segments = (4 * self.max_delta_segments
                                     if max_stalled_segments is None
                                     else int(max_stalled_segments))
        # serving mode: auto-compaction moves off the mutating caller's
        # thread (otherwise one unlucky add pays the whole O(corpus) merge
        # inline — Lucene's ConcurrentMergeScheduler vs SerialMergeScheduler)
        self.background_compaction = bool(background_compaction)
        self._compact_wake = threading.Event()
        self._compactor: Optional[threading.Thread] = None
        self._search_pool = None     # lazy; overlaps delta-segment fetches
        self._closed = False

    # -- snapshot / bookkeeping (callers hold no lock) -------------------------
    def _snapshot(self) -> Tuple[_Segment, ...]:
        with self._lock:
            return self._segments

    def _atomic_snapshot(self):
        """(segments, per-segment tombstone sets) read atomically — the
        tombstone sets are the exact objects current at the read, so a
        later delete (which replaces, never mutates, a set) can't tear a
        reader; _install_merge keys its conflict checks on these
        identities."""
        with self._lock:
            return (self._segments,
                    tuple(s.tombstones for s in self._segments))

    @property
    def num_docs(self) -> int:
        segs = self._snapshot()
        return sum(len(s.id_set - s.tombstones) for s in segs)

    @property
    def num_segments(self) -> int:
        return len(self._snapshot())

    def delete_documents(self, ids: Sequence[str]) -> int:
        """Tombstone ``ids`` wherever they are live; returns how many were."""
        wanted = {str(i) for i in ids}
        hit = 0
        with self._lock:
            for seg in self._segments:
                present = (wanted & seg.id_set) - seg.tombstones
                if present:
                    # replace, don't mutate: in-flight merges iterate the old
                    # set without holding the lock
                    seg.tombstones = seg.tombstones | present
                    hit += len(present)
        return hit

    def _append_segment(self, seg: _Segment, new_ids: Set[str]) -> None:
        """updateDocument semantics: adding ids tombstones every older copy,
        then the new segment joins the snapshot; auto-compacts deltas when
        they pile past ``max_delta_segments`` (base untouched)."""
        with self._lock:
            for old in self._segments:
                dup = (new_ids & old.id_set) - old.tombstones
                if dup:
                    old.tombstones = old.tombstones | dup
            self._segments = self._segments + (seg,)
            need_merge = len(self._segments) - 1 > self.max_delta_segments
        if need_merge:
            if self.background_compaction:
                self._kick_compactor()
                self._stall_writes()
            else:
                self._compact_deltas()

    def _stall_writes(self) -> None:
        """Block the writing thread while the delta count exceeds
        ``max_stalled_segments`` — Lucene's write stall: when sustained
        writes outrun the background compactor, bounding write admission
        (write latency) is the only way to bound read latency. Pure
        polling (writes are ms-scale ops); released by compactor progress,
        ``close()``, or a 120 s safety deadline (a wedged compactor must
        not deadlock every writer)."""
        import time as _time
        if len(self._snapshot()) - 1 <= self.max_stalled_segments:
            return
        deadline = _time.monotonic() + 120.0
        while (not self._closed
               and len(self._snapshot()) - 1 > self.max_stalled_segments):
            self._compact_wake.set()
            if _time.monotonic() > deadline:
                break
            _time.sleep(0.002)

    def _search_segments(self, segs, search_one):
        """Run ``search_one(pos, seg)`` for every segment with the DELTAS
        overlapped on a small thread pool while the base runs on the
        caller's thread: each per-segment search blocks on its own
        device->host fetch, so a sequential loop serializes base + N delta
        round trips; overlapping hides the deltas behind the base (the
        device still runs the kernels in stream order; only the host-side
        dispatch/fetch waits overlap). Results come back in segment order."""
        if len(segs) == 1:
            return [search_one(0, segs[0])]
        with self._lock:
            pool = self._search_pool
            if pool is None and not self._closed:
                from concurrent.futures import ThreadPoolExecutor
                pool = self._search_pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="live-seg-search")
        if pool is None:                   # closed: sequential fallback
            return [search_one(pos, seg) for pos, seg in enumerate(segs)]
        futs = [pool.submit(search_one, pos, seg)
                for pos, seg in enumerate(segs[1:], 1)]
        first = search_one(0, segs[0])
        return [first] + [f.result() for f in futs]

    def _kick_compactor(self) -> None:
        with self._lock:
            if self._closed:
                return
            if self._compactor is None or not self._compactor.is_alive():
                self._compactor = threading.Thread(
                    target=self._compactor_loop, daemon=True,
                    name=f"live-compactor-{id(self):x}")
                self._compactor.start()
        self._compact_wake.set()

    def _compactor_loop(self) -> None:
        while True:
            self._compact_wake.wait()
            self._compact_wake.clear()
            if self._closed:
                return
            self._compact_deltas()

    def wait_compacted(self, timeout: float = 30.0) -> None:
        """Block until the delta count is within bounds (tests / bulk-load
        barriers). No-op for inline compaction."""
        import time
        deadline = time.monotonic() + timeout
        while len(self._snapshot()) - 1 > self.max_delta_segments:
            if time.monotonic() > deadline:
                raise TimeoutError("background compaction did not converge")
            time.sleep(0.005)

    def close(self) -> None:
        """Stop the background compactor and search pool (if any).
        Idempotent; the index remains searchable (single-threaded), only
        the helpers stop."""
        with self._lock:
            self._closed = True
            pool, self._search_pool = self._search_pool, None
        self._compact_wake.set()
        if pool is not None:
            pool.shutdown(wait=False)

    def _install_merge(self, head: Tuple[_Segment, ...],
                       merged_over: Tuple[_Segment, ...],
                       tombs: Sequence[Set[str]],
                       merged: _Segment) -> bool:
        """Install ``merged`` in place of ``merged_over`` iff the merge is
        still valid: the snapshot's ``head + merged_over`` prefix is intact
        (segment identity) and no tombstone landed on a MERGED segment
        since its set ``tombs[i]`` was read. Everything else composes
        without a retry — appended deltas stay as the tail, and deletes
        that only touched ``head`` segments live on those segment objects,
        untouched by the splice. (A bare global version check here
        livelocks under sustained writes: any mutation anywhere would
        abort a merge it cannot actually invalidate.)"""
        n_head = len(head)
        n_merged = len(merged_over)
        with self._lock:
            cur = self._segments
            if len(cur) < n_head + n_merged:
                return False
            if any(a is not b for a, b in zip(cur[:n_head], head)):
                return False
            window = cur[n_head:n_head + n_merged]
            if any(a is not b for a, b in zip(window, merged_over)):
                return False
            if any(seg.tombstones is not t
                   for seg, t in zip(window, tombs)):
                return False
            tail = cur[n_head + n_merged:]
            mid = (merged,) if merged.id_set else ()
            self._segments = head + mid + tail
            return True

    def compact(self) -> None:
        """Merge ALL segments minus tombstones into one fresh base segment
        (plus any deltas appended while the merge ran)."""
        while True:
            segs, tombs = self._atomic_snapshot()
            if not segs:
                return
            merged = self._merge_segments(segs, tombs)
            if self._install_merge((), segs, tombs, merged):
                return

    def _delta_window_start(self, segs: Tuple[_Segment, ...]) -> int:
        """Tiered merge policy: the index into ``segs`` where this pass's
        merge window starts (the window always runs to the current end —
        appends racing the merge become the install's tail).

        Merging ALL deltas every pass is quadratic under sustained writes:
        the single merged delta grows with every add, so each pass costs
        O(total adds) and the compactor falls ever further behind. Instead
        merge log-structured, LSM/Lucene-tiered style: take the smallest suffix that brings the
        count back under ``max_delta_segments`` (always the NEWEST, hence
        smallest, segments — cheap), then cascade into an older delta only
        when it is no bigger than 2× the accumulated window (so a segment
        is re-merged only when its tier doubles — O(log n) merges per
        doc). The steady state is ≤ ``max_delta_segments`` deltas of
        geometrically increasing age/size in front of the untouched base."""
        n_deltas = len(segs) - 1
        over = n_deltas - self.max_delta_segments
        if over <= 0:
            return len(segs)              # nothing to do
        start = len(segs) - (over + 1)    # smallest count-restoring suffix
        start = max(start, 1)             # never touch the base here
        acc = sum(len(segs[i].id_set) for i in range(start, len(segs)))
        while start > 1 and len(segs[start - 1].id_set) <= 2 * acc:
            start -= 1
            acc += len(segs[start].id_set)
        return start

    def _compact_deltas(self) -> None:
        """Merge delta segments only, keeping the base (and its warm device
        matrices) untouched. Loops until the delta
        count is within bounds: both a conflicting install (retry the
        merge) and a successful one (deltas appended while merging may
        still exceed the bound) re-check. Each pass merges a tiered
        window (``_delta_window_start``), not the whole delta set."""
        while True:
            segs, tombs = self._atomic_snapshot()
            j = self._delta_window_start(segs)
            if j >= len(segs):
                return
            merged = self._merge_segments(segs[j:], tombs[j:])
            self._install_merge(segs[:j], segs[j:], tombs[j:], merged)

    # -- persistence ------------------------------------------------------------
    # Layout: <dir>/live.json manifest + one artifact per segment (the
    # segment's own reference-compatible format). A save writes ONE
    # consistent snapshot — updates racing the save land in the snapshot
    # taken or not at all, never half-applied (segments are immutable and
    # tombstone sets are replaced, not mutated).

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        # tombstones are read in the SAME atomic snapshot as the tuple: a
        # replace-add racing the save would otherwise tombstone a doc in a
        # persisted segment while its replacement segment is absent
        segs, tombs = self._atomic_snapshot()
        entries = []
        for i, (seg, tomb) in enumerate(zip(segs, tombs)):
            entries.append({
                "artifact": self._save_segment(seg, directory, i),
                "tombstones": sorted(tomb),
                "n_pad": seg.n_pad,
            })
        with open(os.path.join(directory, "live.json"), "w") as f:
            json.dump({"kind": self._KIND, "segments": entries,
                       "max_delta_segments": self.max_delta_segments,
                       **self._save_extra()}, f)

    @classmethod
    def load(cls, directory: str, **kwargs):
        with open(os.path.join(directory, "live.json")) as f:
            manifest = json.load(f)
        if manifest["kind"] != cls._KIND:
            raise ValueError(f"{directory} holds a {manifest['kind']!r} "
                             f"live index, expected {cls._KIND!r}")
        live = cls(max_delta_segments=manifest["max_delta_segments"],
                   **{**cls._load_extra(manifest), **kwargs})
        segs = []
        for entry in manifest["segments"]:
            seg = live._load_segment(
                os.path.join(directory, entry["artifact"]))
            seg.tombstones = set(entry["tombstones"])
            seg.n_pad = int(entry["n_pad"])
            segs.append(seg)
        live._segments = tuple(segs)
        return live

    # subclasses implement:
    #   _merge_segments(segs, tombs) -> _Segment  (tombs: the atomically-
    #     read tombstone set per segment — NOT seg.tombstones, which a
    #     concurrent delete may have advanced past the merge's version)
    #   _save_segment(seg, directory, i) -> artifact name (relative)
    #   _load_segment(path) -> _Segment (tombstones/n_pad filled by load)
    #   _save_extra() -> dict / _load_extra(manifest) -> ctor kwargs


class LiveDenseIndex(_LiveBase):
    """Incrementally updatable exact-MIPS index over ``DenseFlatIndex``
    segments. See module docstring for the design; the search contract is
    ragged rows (rows can be shorter than ``depth`` after tombstoning a
    small corpus), score-descending, via :meth:`search_rows`."""

    _KIND = "dense"

    def __init__(self, base: Optional[DenseFlatIndex] = None, *,
                 dtype=torch.float32, bucket_min: int = 256,
                 max_delta_segments: int = 8,
                 background_compaction: bool = False,
                 max_stalled_segments: Optional[int] = None,
                 device="cuda"):
        super().__init__(max_delta_segments, background_compaction,
                         max_stalled_segments,
                         device if base is None else base.device)
        self.dtype = dense_dtype(dtype)
        self.bucket_min = int(bucket_min)
        if base is not None and base.size:
            self._segments = (_Segment(base, set(base.lookup)),)
            self.dtype = torch.int8 if base.q8 else base.dtype
        self.dim = base.dim if base is not None else None

    # -- updates ---------------------------------------------------------------
    def add_documents(self, reps: np.ndarray, ids: Sequence[str]) -> None:
        """Add (or replace — latest wins) documents as one delta segment.
        Rows are bucket-padded so deltas come in few shapes;
        duplicate ids within one call keep the LAST row (dict semantics)."""
        reps = np.asarray(reps, np.float32)
        if reps.ndim != 2 or reps.shape[0] != len(ids):
            raise ValueError(f"reps must be [len(ids), d], got {reps.shape} "
                             f"for {len(ids)} ids")
        if self.dim is None:
            self.dim = reps.shape[1]
        elif reps.shape[1] != self.dim:
            # a mismatched delta would poison every later search AND make
            # compaction raise — refuse it here like DenseFlatIndex.add
            raise ValueError(f"dim mismatch: {reps.shape[1]} != {self.dim}")
        ids = [str(i) for i in ids]
        if _PAD_ID in ids:
            raise ValueError("reserved pad id in ids")
        if len(set(ids)) != len(ids):
            keep = {i: j for j, i in enumerate(ids)}          # last wins
            sel = sorted(keep.values())
            reps, ids = reps[sel], [ids[j] for j in sel]
        n = len(ids)
        n_bucket = _bucket(n, self.bucket_min)
        if n_bucket > n:
            reps = np.concatenate(
                [reps, np.zeros((n_bucket - n, reps.shape[1]), np.float32)])
        delta = DenseFlatIndex(dtype=self.dtype, device=self.device)
        delta.add(reps, ids + [_PAD_ID] * (n_bucket - n))
        self._append_segment(_Segment(delta, set(ids), n_pad=n_bucket - n),
                             set(ids))

    # -- search ------------------------------------------------------------------
    def search_rows(self, q_reps: np.ndarray, depth: int,
                    batch_size: int = 128, mesh=None
                    ) -> Tuple[List[List[float]], List[List[str]]]:
        """Batch MIPS over all live documents: per-segment ``search_ids``
        (the base sharded over ``mesh``; deltas on one device, which they
        fit by construction), host top-k merge, tombstones and pad rows
        dropped."""
        segs = tuple(s for s in self._snapshot() if s.index.size)
        if not segs:
            b = np.asarray(q_reps).shape[0]
            return [[] for _ in range(b)], [[] for _ in range(b)]

        def search_one(pos, seg):
            d_f = _fetch_depth(depth, seg.drop_count, seg.index.size)
            scores, ids = seg.index.search_ids(
                q_reps, d_f, batch_size=batch_size,
                mesh=mesh if pos == 0 else None)
            return np.asarray(scores).tolist(), ids

        per_segment = self._search_segments(segs, search_one)
        return _merge_rows(per_segment, segs, depth)

    # -- compaction --------------------------------------------------------------
    def _merge_segments(self, segs: Sequence[_Segment],
                        tombs: Sequence[Set[str]]) -> _Segment:
        merged = DenseFlatIndex(dtype=self.dtype, device=self.device)
        live: Set[str] = set()
        dim = self.dim
        for seg, tomb in zip(segs, tombs):
            idx: DenseFlatIndex = seg.index
            if not idx._chunks:
                continue
            dim = idx.dim
            reps = (np.concatenate(idx._chunks) if len(idx._chunks) > 1
                    else idx._chunks[0])
            ids = np.asarray(idx.lookup)
            dead = tomb | {_PAD_ID}
            keep = ~np.isin(ids, np.asarray(sorted(dead)))
            if keep.any():
                merged.add(reps[keep], ids[keep].tolist())
                live |= set(ids[keep].tolist())
        # merged segments stay bucket-padded too, so post-merge deltas keep
        # sharing shapes with fresh ones
        n_pad = 0
        if live and dim is not None:
            n_pad = _bucket(merged.size, self.bucket_min) - merged.size
            if n_pad:
                merged.add(np.zeros((n_pad, dim), np.float32),
                           [_PAD_ID] * n_pad)
        return _Segment(merged, live, n_pad=n_pad)

    # -- persistence hooks -------------------------------------------------------
    def _save_segment(self, seg: _Segment, directory: str, i: int) -> str:
        name = f"seg{i}.pkl"
        seg.index.save_shard(os.path.join(directory, name))
        return name

    def _load_segment(self, path: str) -> _Segment:
        idx = DenseFlatIndex.load(path, dtype=self.dtype, device=self.device)
        if self.dim is None:
            self.dim = idx.dim
        return _Segment(idx, set(idx.lookup) - {_PAD_ID})

    def _save_extra(self) -> Dict:
        return {"dtype": _DTYPE_NAMES[self.dtype],
                "bucket_min": self.bucket_min}

    @classmethod
    def _load_extra(cls, manifest: Dict) -> Dict:
        return {"dtype": manifest["dtype"],
                "bucket_min": manifest["bucket_min"]}


class LiveImpactIndex(_LiveBase):
    """Incrementally updatable impact index over ``ImpactIndex`` segments.

    Each delta has its own compact term-id space (queries are encoded per
    segment — out-of-vocabulary terms drop per segment exactly as in
    Lucene), and is searched with the ``matmul`` backend; the base keeps
    the caller's backend (the TAAT kernel on the card). The routing is the
    JAX package's (see the module docstring).
    """

    _KIND = "impact"

    def __init__(self, base: Optional[ImpactIndex] = None, *,
                 max_delta_segments: int = 8,
                 query_canonical: Optional[bool] = None,
                 term_keys: Optional[str] = None,
                 background_compaction: bool = False,
                 max_stalled_segments: Optional[int] = None,
                 device="cuda"):
        super().__init__(max_delta_segments, background_compaction,
                         max_stalled_segments,
                         device if base is None else base.device)
        if query_canonical is None:
            query_canonical = (base.query_canonical if base is not None
                               else False)
        self.query_canonical = bool(query_canonical)
        if term_keys not in (None, "int", "str"):
            raise ValueError(f"term_keys must be 'int' or 'str', "
                             f"got {term_keys!r}")
        # declared key space for the EMPTY state (bootstrapping a
        # string-keyed corpus over HTTP needs it before any doc exists);
        # once segments exist their keys are the truth
        self._term_keys_default = term_keys or "int"
        if base is not None and base.num_docs:
            base._ensure_finalized()
            self._segments = (_Segment(base, set(base.doc_ids)),)

    @property
    def int_keyed(self) -> bool:
        """True when every non-empty segment is token-id keyed (the HTTP
        layer's key-coercion contract, same as ``ImpactIndex.int_keyed``);
        an empty live index reports the declared ``term_keys`` default."""
        segs = [s.index for s in self._snapshot() if s.index.num_docs]
        if not segs:
            return self._term_keys_default == "int"
        return all(s.int_keyed for s in segs)

    # -- updates ---------------------------------------------------------------
    def add_documents(self, docs: Sequence[Tuple[str, Dict]]) -> None:
        """Add (or replace — latest wins) ``(doc_id, sparse term dict)``
        documents as one delta segment. Term keys must live in the same key
        space as the base (token ids or strings)."""
        if not docs:
            return
        last: Dict[str, Dict] = {}
        for doc_id, vec in docs:                               # last wins
            last[str(doc_id)] = vec
        delta = ImpactIndex(device=self.device)
        delta.add_many(last.items())
        delta.finalize()
        delta.query_canonical = self.query_canonical
        new_ids = set(last)
        self._append_segment(_Segment(delta, new_ids), new_ids)

    # -- search ------------------------------------------------------------------
    def search_rows(self, terms_list: Sequence[Dict], depth: int,
                    backend: str = "auto", wire: str = "i32", mesh=None
                    ) -> Tuple[List[List[float]], List[List[str]]]:
        """Batch impact search over all live documents (ragged rows, zero-
        score docs never returned — the ``ImpactIndex.search`` contract);
        the base sharded over ``mesh``, the deltas on one device."""
        segs = tuple(s for s in self._snapshot() if s.index.num_docs)
        if not segs:
            return [[] for _ in terms_list], [[] for _ in terms_list]

        def search_one(pos, seg):
            idx: ImpactIndex = seg.index
            d_f = _fetch_depth(depth, seg.drop_count, idx.num_docs)
            q_idx, q_w = idx.encode_queries(terms_list)
            return idx.search_encoded(
                q_idx, q_w, d_f,
                backend=backend if pos == 0 else "matmul",
                wire=wire if pos == 0 else "i32",
                mesh=mesh if pos == 0 else None)

        per_segment = self._search_segments(segs, search_one)
        return _merge_rows(per_segment, segs, depth)

    # -- compaction --------------------------------------------------------------
    def _merge_segments(self, segs: Sequence[_Segment],
                        tombs: Sequence[Set[str]]) -> _Segment:
        live_parts = []
        union: Dict = {}
        for seg, tomb in zip(segs, tombs):
            idx: ImpactIndex = seg.index
            idx._ensure_finalized()
            if not idx.num_docs:
                continue
            keys = [None] * len(idx.term_to_idx)
            for k, i in idx.term_to_idx.items():
                keys[i] = k
            for k in keys:
                if k not in union:
                    union[k] = len(union)
            ids = np.asarray(idx.doc_ids)
            keep = (~np.isin(ids, np.asarray(sorted(tomb)))
                    if tomb else np.ones(len(ids), bool))
            if not keep.any():
                continue
            lut = np.fromiter((union[k] for k in keys), np.int64,
                              len(keys)) if keys else np.zeros(1, np.int64)
            t, w = idx.doc_terms[keep], idx.doc_weights[keep]
            # padding slots (w == 0) may hold any local id; remap is safe
            # (local ids are lut-indexable) and consumers filter on w > 0
            live_parts.append((lut[t].astype(np.int32), w,
                               ids[keep].tolist()))
        merged_ids: List[str] = []
        if live_parts:
            k_max = max(p[0].shape[1] for p in live_parts)
            ts, ws = [], []
            for t, w, ids in live_parts:
                if t.shape[1] < k_max:
                    pad = ((0, 0), (0, k_max - t.shape[1]))
                    t = np.pad(t, pad)
                    w = np.pad(w, pad)
                ts.append(t)
                ws.append(w)
                merged_ids.extend(ids)
            merged = ImpactIndex.from_packed_arrays(
                np.concatenate(ts), np.concatenate(ws), doc_ids=merged_ids,
                term_keys=list(union), device=self.device)
            merged._reorder_terms_by_df()    # hot-first ids for TAAT cache
        else:
            merged = ImpactIndex(device=self.device)
            merged.finalize()
        merged.query_canonical = self.query_canonical
        return _Segment(merged, set(merged_ids))

    # -- persistence hooks -------------------------------------------------------
    def _save_segment(self, seg: _Segment, directory: str, i: int) -> str:
        name = f"seg{i}"
        seg.index.save(os.path.join(directory, name))
        return name

    def _load_segment(self, path: str) -> _Segment:
        idx = ImpactIndex.load(path, device=self.device)
        return _Segment(idx, set(idx.doc_ids))

    def _save_extra(self) -> Dict:
        return {"query_canonical": self.query_canonical,
                "term_keys": self._term_keys_default}

    @classmethod
    def _load_extra(cls, manifest: Dict) -> Dict:
        return {"query_canonical": manifest["query_canonical"],
                "term_keys": manifest.get("term_keys", "int")}
