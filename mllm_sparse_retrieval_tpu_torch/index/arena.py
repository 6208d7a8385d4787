"""Arena live indexes: add, replace and delete documents while serving, at
the cost of a static search (the JAX package's ``index/arena.py``).

The device matrices of the static indexes are dense buffers that take
writes in place; the arena keeps them that way:

- **Reserved capacity.** The impact matrix is allocated with spare doc
  columns and spare term rows (``ImpactIndex.doc_capacity`` /
  ``term_capacity``), the dense corpus with spare rows
  (``DenseFlatIndex._materialize(capacity=...)``), all zero. Reserved
  columns score 0 and the impact resolve drops them; dense searches always
  carry the live mask.
- **add = in-place write.** New documents scatter their (term, column,
  weight) triples into every cached impact matrix
  (``ImpactIndex.scatter_append_triples``) or write their rows into the
  dense corpus (``DenseFlatIndex.write_rows``). The matrix keeps its
  storage, so the TAAT kernel on the card goes on reading the same buffer.
- **delete = tombstone.** A delete clears a host live-mask bit. The impact
  arena also writes zeros over the dead document's cells in every cached
  matrix: impact scores are non-negative and zero-score docs are dropped,
  so impact searches serve the unfiltered static program. The dense arena
  passes the mask as a ``DocFilter`` (a zero inner product can outrank a
  negative real score). ``add_documents`` has Lucene ``updateDocument``
  semantics: re-adding an id tombstones the old copy.
- **compact = rebuild.** When a reservation runs out, the arena repacks the
  live documents into a fresh inner index with new headroom: the one
  O(corpus) event (``_grow``).

Concurrency: a fair reader-writer lock. Searches are readers, mutations
are writers. All threads share the device's default stream, so kernels run
in stream order; the lock guards the host state a search reads across its
dispatch and resolve (``doc_ids``, the doc-id array, ``_n_valid``, the
cached matrices). Results are near-real-time in the Lucene sense: whatever
state the search saw when it took the read lock.

Same serving surface as the segment classes (``index/live.py``):
``add_documents``, ``delete_documents``, ``search_rows``, ``compact``,
``num_docs``, ``num_segments`` (1), ``save``/``load``, ``close``,
``wait_compacted``; ``serving.service`` takes either through the
``live_capable`` flag.

Under a mesh (``search_rows(..., mesh=...)``) the capacity-padded matrix
and corpus shard over its data axis like the static indexes' (doc columns,
corpus rows): an add or a delete routes each triple or row to the shard
that owns its column or row and writes it there in place, and a search
under another mesh (or none) re-places the store first, under the write
lock, as a fresh form does.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.filter import DocFilter
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex

# persisted dense dtype names (the JAX package's ``jnp.dtype(...).name``)
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8"}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def dense_dtype(dtype):
    """A dense corpus dtype from a torch dtype, a numpy dtype or its name
    (``"float32"``, ``"bfloat16"``, ``"int8"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    for t, n in _DTYPE_NAMES.items():
        if n == name:
            return t
    raise TypeError(f"dense dtype {dtype!r}: float32, bfloat16 or int8")


class _RWLock:
    """No-starvation reader-writer lock (turnstile pattern): readers share;
    a waiting writer holds the turnstile so new readers queue behind it,
    and a releasing writer re-queues through the turnstile behind waiting
    readers, so a continuous writer cannot starve searches. Not reentrant
    in either direction."""

    def __init__(self):
        self._turnstile = threading.Lock()
        self._readers_mu = threading.Lock()
        self._readers = 0
        self._wlock = threading.Lock()

    @contextlib.contextmanager
    def read(self):
        with self._turnstile:        # queue behind any waiting writer
            pass
        with self._readers_mu:
            self._readers += 1
            if self._readers == 1:
                self._wlock.acquire()
        try:
            yield
        finally:
            with self._readers_mu:
                self._readers -= 1
                if self._readers == 0:
                    self._wlock.release()

    @contextlib.contextmanager
    def write(self):
        with self._turnstile:        # blocks new readers while we wait
            self._wlock.acquire()
        try:
            yield
        finally:
            self._wlock.release()


class _ArenaBase:
    """Shared lock, tombstone and position bookkeeping."""

    live_capable = True           # serving.service protocol flag

    def __init__(self):
        self._rw = _RWLock()
        self._live = np.zeros(0, np.bool_)   # per-position liveness
        self._pos: Dict[str, int] = {}       # id -> its one live position
        self._tomb_count = 0
        self._filter: Optional[DocFilter] = None

    @property
    def num_docs(self) -> int:
        return len(self._pos)

    @property
    def num_segments(self) -> int:
        return 1

    def delete_documents(self, ids: Sequence[str]) -> int:
        with self._rw.write():
            return self._tombstone([str(i) for i in ids])

    def _tombstone(self, ids) -> int:
        """Tombstone the live positions of ``ids`` (caller holds the write
        lock); returns how many were live. Also the updateDocument half of
        an add."""
        dead: List[int] = []
        for i in ids:
            pos = self._pos.pop(i, None)
            if pos is not None:
                self._live[pos] = False
                dead.append(pos)
        if dead:
            self._tomb_count += len(dead)
            self._filter = None
            self._on_tombstoned(dead)
        return len(dead)

    def _on_tombstoned(self, positions: List[int]) -> None:
        """Subclass hook, called under the write lock with the positions
        that just went dead. Default: nothing (the live-mask filter
        excludes them)."""
        return None

    def _live_filter(self) -> DocFilter:
        """Cached allow mask over current positions (called under the read
        lock; the build is an idempotent snapshot)."""
        f = self._filter
        if f is None:
            f = self._filter = DocFilter(self._live.copy())
        return f

    # segment-API compatibility: arena compaction is inline and bounded
    def wait_compacted(self, timeout: float = 30.0) -> None:
        return None

    def close(self) -> None:
        return None


class ArenaImpactIndex(_ArenaBase):
    """Mutable impact index over one capacity-reserved ``ImpactIndex``.

    ``doc_headroom`` / ``term_headroom``: reserved space beyond the current
    corpus; exceeding either runs an inline compact-and-grow. The inner
    index's device cache is dropped on adoption (its matrices were sized
    without headroom) and rebuilt with capacity on the next search. An
    empty arena lives on ``device``; one over ``base`` on the base's.
    """

    _KIND = "impact-arena"

    def __init__(self, base: Optional[ImpactIndex] = None, *,
                 doc_headroom: int = 8192,
                 term_headroom: Optional[int] = None,
                 query_canonical: Optional[bool] = None,
                 term_keys: Optional[str] = None,
                 background_compaction: bool = False,  # accepted, inline
                 device="cuda"):
        super().__init__()
        inner = base if base is not None else ImpactIndex(device=device)
        inner._ensure_finalized()
        if query_canonical is None:
            query_canonical = bool(getattr(inner, "query_canonical", False))
        self.query_canonical = bool(query_canonical)
        inner.query_canonical = self.query_canonical
        if term_keys not in (None, "int", "str"):
            raise ValueError(f"term_keys must be 'int' or 'str', "
                             f"got {term_keys!r}")
        self._term_keys_default = term_keys or "int"
        self.doc_headroom = int(doc_headroom)
        # reserved term rows cost the TAAT kernel nothing (it reads only
        # the query's rows) but the matmul backend's table x matrix scales
        # with them: the default headroom adapts to the vocabulary
        self.term_headroom = None if term_headroom is None \
            else int(term_headroom)
        self._adopt(inner)

    def _term_headroom(self, t: int) -> int:
        return self.term_headroom if self.term_headroom is not None \
            else max(1024, t // 8)

    def _adopt(self, inner: ImpactIndex) -> None:
        """Install ``inner`` as the arena store with fresh capacities and
        bookkeeping. Caller holds the write lock (or is the constructor)."""
        inner.drop_device_cache()
        n = inner.num_docs
        t = len(inner.term_to_idx)
        inner.doc_capacity = n + self.doc_headroom
        inner.term_capacity = t + self._term_headroom(t)
        self._inner = inner
        self._pend_count = 0           # docs appended since the CSR build
        self._live = np.ones(n, np.bool_)
        self._pos = {d: i for i, d in enumerate(inner.doc_ids)}
        self._tomb_count = 0
        self._filter = None

    # -- protocol mirrors ------------------------------------------------------
    @property
    def int_keyed(self) -> bool:
        if not self._inner.term_to_idx and not self._inner.num_docs:
            return self._term_keys_default == "int"
        return self._inner.int_keyed

    @property
    def term_to_idx(self):
        """The live term-key space (grows with added documents)."""
        return self._inner.term_to_idx

    # -- updates ---------------------------------------------------------------
    def add_documents(self, docs: Sequence[Tuple[str, Dict]]) -> None:
        """Add (or replace: the latest wins) ``(doc_id, sparse term dict)``
        documents. Weights follow ``ImpactIndex.add``: ``int`` truncation,
        non-positive ones dropped."""
        if not docs:
            return
        last: Dict[str, Dict] = {}
        for doc_id, vec in docs:                              # last wins
            last[str(doc_id)] = {k: int(v) for k, v in vec.items()
                                 if int(v) > 0}
        with self._rw.write():
            inner = self._inner
            t2i = inner.term_to_idx
            new_keys: List = []
            seen: Set = set()
            for vec in last.values():
                for k in vec:
                    if k not in t2i and k not in seen:
                        seen.add(k)
                        new_keys.append(k)
            m = len(last)
            if (len(inner.doc_ids) + m > inner.doc_capacity or
                    len(t2i) + len(new_keys) > inner.term_capacity):
                self._grow(extra_docs=m, extra_terms=len(new_keys))
                inner = self._inner
                t2i = inner.term_to_idx
            for k in new_keys:
                t2i[k] = len(t2i)

            ids = list(last)
            self._tombstone(ids)
            start = len(inner.doc_ids)
            k_have = inner.doc_terms.shape[1]
            k_need = max((len(v) for v in last.values()), default=1)
            if k_need > k_have:
                pad = ((0, 0), (0, k_need - k_have))
                inner.doc_terms = np.pad(inner.doc_terms, pad)
                inner.doc_weights = np.pad(inner.doc_weights, pad)
                k_have = k_need
            dt = np.zeros((m, k_have), np.int32)
            dw = np.zeros((m, k_have), np.float32)
            for r, vec in enumerate(last.values()):
                for c, (k, w) in enumerate(vec.items()):
                    dt[r, c] = t2i[k]
                    dw[r, c] = w
            inner.doc_terms = np.concatenate([inner.doc_terms, dt])
            inner.doc_weights = np.concatenate([inner.doc_weights, dw])
            inner.doc_ids.extend(ids)
            inner._doc_ids_arr_src = None
            self._live = np.concatenate([self._live, np.ones(m, np.bool_)])
            for r, i in enumerate(ids):
                self._pos[i] = start + r
            self._filter = None
            self._pend_count += m

            # flat triples for the in-place device scatter
            rows = np.nonzero(dw > 0)
            tr_terms = dt[rows]
            tr_cols = rows[0] + start
            tr_vals = dw[rows]
            # int16 exactness can only degrade with adds: a weight that
            # overflows int16 drops the cached i16 matrices (the next TAAT
            # search folds and rebuilds in f32)
            if tr_vals.size and tr_vals.max() >= 32767.5:
                inner._i16_ok = False
                if inner._dev:
                    inner._dev.pop("i16", None)
            inner.scatter_append_triples(tr_terms, tr_cols, tr_vals)

    def _grow(self, extra_docs: int = 0, extra_terms: int = 0) -> None:
        """Compact live docs into a fresh inner index with new headroom
        (caller holds the write lock). The only O(corpus) mutation."""
        inner = self._inner
        live = self._live
        merged = ImpactIndex.from_packed_arrays(
            inner.doc_terms[live], inner.doc_weights[live],
            doc_ids=np.asarray(inner.doc_ids)[live].tolist(),
            term_keys=list(inner.term_to_idx), device=inner.device)
        merged._reorder_terms_by_df()      # hot-first ids, as built
        merged.query_canonical = self.query_canonical
        merged.hbm_budget_bytes = inner.hbm_budget_bytes
        self.doc_headroom = max(self.doc_headroom, extra_docs)
        if extra_terms > self._term_headroom(len(merged.term_to_idx)):
            self.term_headroom = extra_terms
        self._adopt(merged)

    def compact(self) -> None:
        with self._rw.write():
            if self._tomb_count:
                self._grow()
            elif self._pend_count:
                self._fold_pending()

    # -- tombstones = zeroed doc columns ----------------------------------------
    def _on_tombstoned(self, positions: List[int]) -> None:
        if self._inner._dev:
            self._scatter_zeros(positions)

    def _scatter_zeros(self, positions: Sequence[int]) -> None:
        """Write zeros over the given doc positions' populated cells in
        every cached device matrix (caller holds the write lock).
        Idempotent."""
        inner = self._inner
        pos = np.asarray(list(positions), np.int64)
        if pos.size == 0:
            return
        rows_t = inner.doc_terms[pos]          # [m, k] term idx (pad = 0)
        rows_w = inner.doc_weights[pos]        # [m, k] weights (pad = 0)
        ri, ci = np.nonzero(rows_w > 0)
        if ri.size == 0:
            return
        inner.scatter_append_triples(rows_t[ri, ci], pos[ri],
                                     np.zeros(ri.size, np.float32))

    def _dead_positions(self) -> np.ndarray:
        return np.nonzero(~self._live)[0]

    def _fold_pending(self) -> None:
        """Rebuild the inner CSR from the already-appended packed rows, so
        a fresh device matrix sees every doc; cached matrices already hold
        the appended triples and are kept. Caller holds the write lock."""
        inner = self._inner
        dev = inner._dev
        inner._build_csr()                 # resets _dev and _i16_ok
        inner._dev = dev
        self._pend_count = 0

    # -- search ------------------------------------------------------------------
    def search_rows(self, terms_list: Sequence[Dict], depth: int,
                    backend: str = "auto", wire: str = "i32", mesh=None
                    ) -> Tuple[List[List[float]], List[List[str]]]:
        """Batch impact search over the live documents (the ragged-row
        ``ImpactIndex.search`` contract), over ``mesh`` when one is given.
        This is the static search program, tombstones or not: deletes
        zeroed the dead doc columns in place in every cached matrix, so no
        filter and no wire downgrade."""
        for _ in range(4):
            if self._form_stale(backend, mesh):
                # a fresh device matrix would be built from the stale CSR:
                # fold the appended rows in and materialize it now, under
                # the write lock, so later add-scatters cover it; it is
                # built from a CSR that still holds tombstoned docs, so
                # re-zero the dead columns (deletes never resurrect)
                with self._rw.write():
                    self._fold_and_materialize(backend, mesh)
            with self._rw.read():
                if not self._inner.num_docs:
                    return ([[] for _ in terms_list],
                            [[] for _ in terms_list])
                if self._form_stale(backend, mesh):
                    # a write between the check above and this read lock
                    # invalidated the matrix (an add with a weight >= 32768
                    # dropped the i16 form): building it here, under only
                    # the read lock, would skip the re-zero of tombstoned
                    # columns. Go round to the write-side path.
                    continue
                return self._search_locked(terms_list, depth, backend, wire,
                                           mesh)
        # pathological writer churn: search exclusively
        with self._rw.write():
            self._fold_and_materialize(backend, mesh)
            if not self._inner.num_docs:
                return [[] for _ in terms_list], [[] for _ in terms_list]
            return self._search_locked(terms_list, depth, backend, wire,
                                       mesh)

    def _fold_and_materialize(self, backend: str, mesh=None) -> None:
        """Write-side preparation: fold appended rows into the CSR,
        materialize the matrix the search plan resolves to, and re-zero
        tombstoned columns on it. Caller holds the write lock."""
        if self._pend_count:
            self._fold_pending()
        if self._inner.num_docs:
            self._inner._materialize(self._resolve_form(backend, mesh), mesh)
            if self._tomb_count:
                self._scatter_zeros(self._dead_positions())

    def _search_locked(self, terms_list, depth, backend: str, wire: str,
                       mesh=None):
        """The search body; caller holds the read or write lock and has
        checked that the device matrix is current."""
        inner = self._inner
        q_idx, q_w = inner.encode_queries(terms_list)
        return inner.search_encoded(q_idx, q_w, depth, backend=backend,
                                    wire=wire, mesh=mesh)

    def _resolve_form(self, backend: str, mesh=None) -> str:
        """The cache key (``"i16"`` / ``"f32"``) of the matrix the search
        plan will use: ``ImpactIndex._search_plan``'s rule."""
        if backend == "auto":
            lead = self._inner.device if mesh is None else mesh.lead
            backend = "taat" if lead.type == "cuda" else "matmul"
        return "i16" if backend == "taat" and self._inner._int16_exact() \
            else "f32"

    def _form_stale(self, backend: str, mesh=None) -> bool:
        """True when ``search_encoded`` would build a device matrix rather
        than hit the cache, i.e. the add-scatters have not covered this
        search: no cached form, another mesh's, or not this backend's.
        Appended but unfolded rows do not make a cached matrix stale: the
        scatters already wrote them into it."""
        inner = self._inner
        return (inner._dev is None or inner._mesh is not mesh
                or self._resolve_form(backend, mesh) not in inner._dev)

    # -- persistence ------------------------------------------------------------
    def save(self, directory: str) -> None:
        """Persist one compacted snapshot (live docs only): a plain
        ``ImpactIndex`` artifact ``seg0/`` and a ``live.json`` manifest, the
        JAX package's format. Loading starts a fresh arena with full
        headroom."""
        with self._rw.write():
            os.makedirs(directory, exist_ok=True)
            inner = self._inner
            live = self._live
            snap = ImpactIndex.from_packed_arrays(
                inner.doc_terms[live], inner.doc_weights[live],
                doc_ids=np.asarray(inner.doc_ids)[live].tolist(),
                term_keys=list(inner.term_to_idx), device=inner.device)
            snap.query_canonical = self.query_canonical
            snap.save(os.path.join(directory, "seg0"))
            with open(os.path.join(directory, "live.json"), "w") as f:
                json.dump({"kind": self._KIND,
                           "query_canonical": self.query_canonical,
                           "term_keys": self._term_keys_default,
                           "doc_headroom": self.doc_headroom,
                           "term_headroom": self.term_headroom}, f)

    @classmethod
    def load(cls, directory: str, device="cuda",
             **kwargs) -> "ArenaImpactIndex":
        with open(os.path.join(directory, "live.json")) as f:
            manifest = json.load(f)
        if manifest["kind"] != cls._KIND:
            raise ValueError(f"{directory} holds a {manifest['kind']!r} "
                             f"live index, expected {cls._KIND!r}")
        inner = ImpactIndex.load(os.path.join(directory, "seg0"),
                                 device=device)
        kw = {"query_canonical": manifest["query_canonical"],
              "term_keys": manifest.get("term_keys", "int"),
              "doc_headroom": manifest["doc_headroom"],
              "term_headroom": manifest["term_headroom"], **kwargs}
        return cls(inner, **kw)


class ArenaDenseIndex(_ArenaBase):
    """Mutable exact-MIPS index over one capacity-reserved
    ``DenseFlatIndex``. Reserved rows are zero vectors; every search
    carries the live-mask filter (a zero inner product can outrank a
    negative real score, so unlike the impact arena the mask is always
    on). An empty arena lives on ``device``; one over ``base`` on the
    base's."""

    _KIND = "dense-arena"

    def __init__(self, base: Optional[DenseFlatIndex] = None, *,
                 dtype=torch.float32, doc_headroom: int = 8192,
                 background_compaction: bool = False,  # accepted, inline
                 device="cuda"):
        super().__init__()
        inner = base if base is not None else DenseFlatIndex(
            dtype=dense_dtype(dtype), device=device)
        self.dtype = torch.int8 if inner.q8 else inner.dtype
        self.doc_headroom = int(doc_headroom)
        self._adopt(inner)

    def _adopt(self, inner: DenseFlatIndex) -> None:
        inner._corpus_dev = None
        inner._row_scale_dev = None
        self._inner = inner
        self.dim = inner.dim
        # linear rounding, not a power of two: the MIPS product's work
        # scales with the row capacity. A multiple of 1024 keeps the SQ8
        # corpus's rows a multiple of Q8_ALIGN.
        self._capacity = _round_up(inner.size + self.doc_headroom, 1024)
        self._live = np.ones(inner.size, np.bool_)
        self._pos = {d: i for i, d in enumerate(inner.lookup)}
        self._tomb_count = 0
        self._filter = None

    # -- device placement --------------------------------------------------------
    def _placed(self, mesh) -> bool:
        inner = self._inner
        return inner._corpus_dev is not None and inner._mesh is mesh

    def _ensure_dev(self, mesh=None) -> None:
        """Place the capacity-padded corpus if it is not placed for
        ``mesh`` (caller holds the write lock: the placement swaps inner
        device state)."""
        if not self._placed(mesh):
            self._inner._materialize(capacity=self._capacity, mesh=mesh)

    # -- updates ---------------------------------------------------------------
    def add_documents(self, reps: np.ndarray, ids: Sequence[str]) -> None:
        """Add (or replace: the latest wins) documents; duplicate ids within
        one call keep the last row (dict semantics, as in the segment
        class)."""
        reps = np.asarray(reps, np.float32)
        if reps.ndim != 2 or reps.shape[0] != len(ids):
            raise ValueError(f"reps must be [len(ids), d], got {reps.shape} "
                             f"for {len(ids)} ids")
        ids = [str(i) for i in ids]
        if len(set(ids)) != len(ids):
            keep = {i: j for j, i in enumerate(ids)}          # last wins
            sel = sorted(keep.values())
            reps, ids = reps[sel], [ids[j] for j in sel]
        with self._rw.write():
            inner = self._inner
            if self.dim is None:
                self.dim = inner.dim = reps.shape[1]
            elif reps.shape[1] != self.dim:
                raise ValueError(
                    f"dim mismatch: {reps.shape[1]} != {self.dim}")
            m = len(ids)
            if inner.size + m > self._capacity:
                self._grow(extra=m)
                inner = self._inner
            self._tombstone(ids)
            start = inner.size
            inner._chunks.append(reps)
            inner.lookup.extend(ids)
            inner._lookup_arr_src = None
            self._live = np.concatenate([self._live, np.ones(m, np.bool_)])
            for r, i in enumerate(ids):
                self._pos[i] = start + r
            self._filter = None
            inner.write_rows(reps, start)

    def _grow(self, extra: int = 0) -> None:
        """Caller holds the write lock."""
        inner = self._inner
        live = self._live
        merged = DenseFlatIndex(dim=self.dim, dtype=self.dtype,
                                device=inner.device)
        if live.any():
            merged.add(inner._host_corpus()[live],
                       np.asarray(inner.lookup)[live].tolist())
        self.doc_headroom = max(self.doc_headroom, extra)
        self._adopt(merged)

    def compact(self) -> None:
        with self._rw.write():
            if self._tomb_count:
                self._grow()

    # -- search ------------------------------------------------------------------
    def search_rows(self, q_reps: np.ndarray, depth: int,
                    batch_size: int = 128, mesh=None
                    ) -> Tuple[List[List[float]], List[List[str]]]:
        """Batch MIPS over the live documents, over ``mesh`` when one is
        given; the live mask rides every search as a doc filter."""
        while True:
            if not self._placed(mesh):
                with self._rw.write():
                    if self._pos:
                        self._ensure_dev(mesh)
            with self._rw.read():
                inner = self._inner
                if not self._pos:
                    b = np.asarray(q_reps).shape[0]
                    return [[] for _ in range(b)], [[] for _ in range(b)]
                if not self._placed(mesh):
                    # a racing _grow (or a search under another mesh)
                    # dropped this placement: place it under the write
                    # lock and go round
                    continue
                return inner.search_ids(q_reps, depth,
                                        batch_size=batch_size,
                                        doc_filter=self._live_filter(),
                                        mesh=mesh)

    # -- persistence ------------------------------------------------------------
    def save(self, directory: str) -> None:
        """One compacted snapshot: live rows as a reference-compatible
        ``seg0.pkl`` and a ``live.json`` manifest (the JAX package's
        format)."""
        with self._rw.write():
            os.makedirs(directory, exist_ok=True)
            inner = self._inner
            live = self._live
            snap = DenseFlatIndex(dim=self.dim, dtype=self.dtype,
                                  device=inner.device)
            if live.any():
                snap.add(inner._host_corpus()[live],
                         np.asarray(inner.lookup)[live].tolist())
            snap.save_shard(os.path.join(directory, "seg0.pkl"))
            with open(os.path.join(directory, "live.json"), "w") as f:
                json.dump({"kind": self._KIND,
                           "dtype": _DTYPE_NAMES[self.dtype],
                           "doc_headroom": self.doc_headroom}, f)

    @classmethod
    def load(cls, directory: str, device="cuda",
             **kwargs) -> "ArenaDenseIndex":
        with open(os.path.join(directory, "live.json")) as f:
            manifest = json.load(f)
        if manifest["kind"] != cls._KIND:
            raise ValueError(f"{directory} holds a {manifest['kind']!r} "
                             f"live index, expected {cls._KIND!r}")
        dtype = dense_dtype(kwargs.pop("dtype", None) or manifest["dtype"])
        inner = DenseFlatIndex.load(os.path.join(directory, "seg0.pkl"),
                                    dtype=dtype, device=device)
        return cls(inner, dtype=dtype,
                   doc_headroom=manifest["doc_headroom"], **kwargs)
