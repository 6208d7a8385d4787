"""Transport-free retrieval service: validated queries -> micro-batched
device calls (the JAX package's ``serving/service.py``).

The mode is fixed by the indexes given:

- ``sparse``: an :class:`ImpactIndex` (the TAAT kernel on the card), its
  results copied back on the i32 wire or, with ``wire="compact48"``, in 6
  bytes each (integer weights only; filtered requests too);
- ``dense``: a :class:`DenseFlatIndex` (f32, bf16 or SQ8 int8 MIPS) or a
  :class:`DenseANNIndex` (low-rank prefilter, exact rescore);
- ``hybrid``: both. Under the default min-max rule a micro-batch runs
  through :class:`FusedHybridSearcher` (both engines' top-k fused on the
  device, one copy to the host); requests with a doc filter, and every
  request under ``fusion_rule="rrf"``, fuse the two engines' candidate rows
  on the host with ``search.fusion``, the sparse engine on a side thread.

Concurrent single queries coalesce in a :class:`MicroBatcher` into one
encode + search per micro-batch; requests may carry ``terms`` / ``dense``
or raw ``text`` / ``image`` (encoded live by a ``query_encoder``), and a
registered doc filter (``register_filter``). Depths are quantized up to
fixed levels and each request's result is cut back to what it asked for.

Each slot also takes a live index (the arena classes of
``index/arena.py`` or the segment classes of ``index/live.py``, both
flagged ``live_capable``): the service then exposes ``add_documents``,
``delete_documents``, ``compact`` and ``save_live`` and keeps serving
through them; ``load_live_state`` restores a save. Live hybrid fuses the
two engines' candidate rows on the host (``search.fusion.fuse``); the
device-fused path needs one immutable doc permutation. One
``add_documents`` call updates the sparse engine first, then the dense
one: a search landing between the two may fuse a doc from one engine
only, which ``fuse``'s missing-run rule scores as a transiently lower
score, never an error. A static service swaps in freshly built indexes
with ``reload_indexes`` without dropping requests.
"""

from __future__ import annotations

import bisect
import json
import operator
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from mllm_sparse_retrieval_tpu_torch.index.arena import (
    ArenaDenseIndex, ArenaImpactIndex)
from mllm_sparse_retrieval_tpu_torch.index.filter import DocFilter
from mllm_sparse_retrieval_tpu_torch.index.live import (
    _PAD_ID, LiveDenseIndex, LiveImpactIndex)
from mllm_sparse_retrieval_tpu_torch.search.device_fusion import (
    FusedHybridSearcher)
from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse, fuse_rrf
from mllm_sparse_retrieval_tpu_torch.serving.batcher import MicroBatcher
from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
    canonical_id_map)

TermsLike = Union[Mapping[object, float], Sequence[Tuple[object, float]]]


@dataclass(frozen=True)
class QueryRequest:
    """One validated query: ``terms`` keyed by the impact index's key space,
    ``dense`` a ``[d]`` float vector, or raw ``text`` or ``image`` (needs a
    ``query_encoder``); the requested ``depth``, and the name of a
    registered doc ``filter``."""
    terms: Optional[Dict[object, float]]
    dense: Optional[np.ndarray]
    depth: int
    text: Optional[str] = None
    image: Optional[np.ndarray] = None   # raw [H, W, 3] float in [0, 1]
    filter: Optional[str] = None


class RetrievalService:
    """Micro-batched retrieval over prebuilt or live indexes.

    ``search`` / ``search_async`` are thread-safe; each call is one query.
    Requests must carry what the mode needs and are validated on the
    caller's thread, so malformed input never poisons a batch. ``close()``
    stops the dispatcher thread, the hybrid side thread and a live index's
    background compactor.
    """

    def __init__(self, dense_index=None, impact_index=None, *,
                 alpha: float = 0.5,
                 depth_levels: Sequence[int] = (10, 100, 1000),
                 default_depth: int = 10,
                 candidate_depth: Optional[int] = None,
                 backend: str = "auto", wire: str = "i32",
                 max_batch: int = 256,
                 max_wait_ms: float = 4.0,
                 device_batch: Optional[int] = None, query_encoder=None,
                 live_state_dir: Optional[str] = None,
                 filters: Optional[Mapping] = None,
                 fusion_rule: str = "minmax"):
        if dense_index is None and impact_index is None:
            raise ValueError("need at least one of dense_index/impact_index")
        self.dense_index = dense_index
        self.impact_index = impact_index
        # the flag both live families carry: the segment classes
        # (index/live.py) and the arena classes (index/arena.py)
        self._dense_live = bool(getattr(dense_index, "live_capable", False))
        self._impact_live = bool(getattr(impact_index, "live_capable",
                                         False))
        self.live = self._dense_live or self._impact_live
        self.mode = ("hybrid" if dense_index is not None
                     and impact_index is not None
                     else "dense" if dense_index is not None else "sparse")
        if self.live and not all(
                (dense_index is None or self._dense_live,
                 impact_index is None or self._impact_live)):
            raise ValueError(
                "mixing a live index with a static one is not supported: "
                "updates would apply to one engine only — wrap the static "
                "index in its live class (index/arena.py, index/live.py)")
        if live_state_dir is not None and not self.live:
            raise ValueError("live_state_dir requires live indexes")
        self.live_state_dir = live_state_dir
        self.depth_levels = tuple(sorted(set(int(d) for d in depth_levels)))
        if any(d < 1 for d in self.depth_levels):
            raise ValueError(f"depth_levels must be >= 1: {depth_levels}")
        self.default_depth = int(default_depth)
        if self.default_depth > self.depth_levels[-1]:
            raise ValueError("default_depth exceeds max depth level")
        # hybrid: each engine's depth before fusion; the served depth stays
        # the request's
        self.candidate_depth = candidate_depth
        self.backend = backend
        if wire not in ("i32", "compact48"):
            raise ValueError(f"unknown wire {wire!r}: 'i32' or 'compact48'")
        self.wire = wire
        # every micro-batch is padded to this fixed device batch, so the
        # encoder and the searches always see one shape
        self.device_batch = int(device_batch or max_batch)
        if self.device_batch < max_batch:
            raise ValueError("device_batch must be >= max_batch")
        self.query_encoder = query_encoder
        self._cmap = self._build_cmap(impact_index)
        self.alpha = float(alpha)
        if fusion_rule not in ("minmax", "rrf"):
            raise ValueError(f"fusion_rule must be 'minmax' or 'rrf', "
                             f"got {fusion_rule!r}")
        # rrf routes hybrid through the host fusion (the device fusion
        # implements the min-max rule)
        self.fusion_rule = fusion_rule
        self._fused = None
        self._engine_pool = None
        if self.mode == "hybrid":
            if fusion_rule != "rrf" and not self.live:
                self._fused = FusedHybridSearcher(
                    dense_index, impact_index, alpha=alpha, backend=backend)
            # host-fused hybrid (live indexes, filtered requests, rrf) runs
            # the sparse engine on this thread, so the two engines' work
            # overlaps
            self._engine_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hybrid-sparse")
        # serializes reload_indexes against batch execution: a batch never
        # mixes old engines with filters built for the new ones
        self._swap_lock = threading.Lock()
        # named doc filters: one DocFilter per engine per name (the
        # engines' doc orders differ)
        self._filters: Dict[str, Dict[str, object]] = {}
        for name, ids in (filters or {}).items():
            self.register_filter(name, ids)
        self._batcher = MicroBatcher(self._run_batch, max_batch=max_batch,
                                     max_wait_ms=max_wait_ms,
                                     name="retrieval-batcher")

    # ---- public API ----------------------------------------------------------
    def search_async(self, terms: Optional[TermsLike] = None, dense=None,
                     depth: Optional[int] = None, text: Optional[str] = None,
                     image=None, filter: Optional[str] = None) -> Future:
        return self._batcher.submit(self._validate(terms, dense, depth, text,
                                                   image, filter))

    def search(self, terms: Optional[TermsLike] = None, dense=None,
               depth: Optional[int] = None, text: Optional[str] = None,
               image=None, filter: Optional[str] = None,
               timeout: Optional[float] = 60.0):
        """Blocking single query -> list of ``(doc_id, score)``,
        score-descending, at most ``depth`` entries. Give ``text`` or
        ``image`` (a raw ``[H, W, 3]`` float array in [0, 1], any size;
        encoded live, needs a ``query_encoder``), or explicit ``terms``
        and/or ``dense`` as the mode needs. ``filter`` names a registered
        doc filter (``register_filter``)."""
        return self.search_async(terms, dense, depth, text, image,
                                 filter).result(timeout)

    def stats(self) -> Dict[str, float]:
        s = self._batcher.stats()
        s["mode"] = self.mode
        s["live"] = self.live
        if self._dense_live:
            s["dense_docs"] = self.dense_index.num_docs
            s["dense_segments"] = self.dense_index.num_segments
        if self._impact_live:
            s["sparse_docs"] = self.impact_index.num_docs
            s["sparse_segments"] = self.impact_index.num_segments
        return s

    def close(self) -> None:
        self._batcher.close()
        if self._engine_pool is not None:
            self._engine_pool.shutdown(wait=False)
        for idx in (self.dense_index, self.impact_index):
            if idx is not None and hasattr(idx, "close"):
                idx.close()       # stops a live index's background compactor

    def _build_cmap(self, impact_index):
        """The query canonical map: applied iff the index was BUILT with
        canonical id-collision merges (``query_canonical``)."""
        if (self.query_encoder is None or impact_index is None
                or not getattr(impact_index, "query_canonical", False)):
            return None
        return canonical_id_map(self.query_encoder.tokenizer.get_vocab(),
                                self.query_encoder.sparse_cfg.is_filtered)

    # ---- named doc filters ---------------------------------------------------
    def register_filter(self, name: str, ids, mode: str = "allow") -> int:
        """Register (or replace) a named doc filter; requests carrying
        ``filter=name`` search only the docs it allows. Static indexes
        only: a live corpus would invalidate the mask on every add.
        Returns the allowed doc count (of the dense engine where there is
        one)."""
        if self.live:
            raise ValueError("doc filters require static indexes (a live "
                             "corpus invalidates the mask on every add)")
        ids = [str(i) for i in ids]
        while True:
            # the O(n_docs) mask builds run outside the lock (they would
            # stall every batch); the install re-checks the engines and
            # goes round if a reload swapped them mid-build
            with self._swap_lock:
                dense, impact = self.dense_index, self.impact_index
            entry = self._filter_entry(ids, mode, dense, impact)
            with self._swap_lock:
                if self.dense_index is dense and \
                        self.impact_index is impact:
                    self._filters[str(name)] = entry
                    break
        return entry["dense" if "dense" in entry else "sparse"].n_allowed

    @staticmethod
    def _filter_entry(ids, mode, dense, impact) -> Dict[str, object]:
        """One registry entry: the id list and one ``DocFilter`` per
        engine (the engines' doc orders differ)."""
        entry: Dict[str, object] = {"ids": ids, "mode": mode}
        if dense is not None:
            entry["dense"] = DocFilter.from_ids(dense.lookup, ids, mode)
        if impact is not None:
            entry["sparse"] = DocFilter.from_ids(impact.doc_ids, ids, mode)
        return entry

    def reload_indexes(self, dense_index=None, impact_index=None) -> None:
        """Swap in freshly built static indexes without a restart or a
        dropped request. The engines present must match the serving mode;
        registered filters rebuild against the new doc orders from their
        stored id lists; the device-fused hybrid searcher is rebuilt.
        In-flight batches finish on the old engines; the dispatcher takes
        the new ones from its next batch."""
        if self.live:
            raise ValueError("reload_indexes is for static serving; a live "
                             "service mutates in place (add/delete/compact)")
        if getattr(dense_index, "live_capable", False) or \
                getattr(impact_index, "live_capable", False):
            raise ValueError("reload_indexes takes static indexes")
        if (dense_index is None) != (self.dense_index is None) or \
                (impact_index is None) != (self.impact_index is None):
            raise ValueError(
                f"mode={self.mode!r} service needs "
                f"{'dense ' if self.dense_index is not None else ''}"
                f"{'sparse' if self.impact_index is not None else ''}"
                " replacement indexes (presence must match)")
        if dense_index is not None and self.dense_index.dim is not None \
                and dense_index.dim is not None \
                and dense_index.dim != self.dense_index.dim:
            # caught here, not as shape errors failing whole micro-batches
            # of already-validated queries
            raise ValueError(
                f"replacement dense dim {dense_index.dim} != serving dim "
                f"{self.dense_index.dim} (a dim migration needs a restart)")
        new_fused = None
        if self.mode == "hybrid" and self.fusion_rule != "rrf":
            new_fused = FusedHybridSearcher(
                dense_index, impact_index, alpha=self.alpha,
                backend=self.backend)
        # the canonical map follows the sparse index's query_canonical flag
        new_cmap = self._build_cmap(impact_index)
        while True:
            # filter rebuilds run outside the lock; the install re-checks
            # the registry so a registration racing the reload is kept
            with self._swap_lock:
                snapshot = dict(self._filters)
            new_filters = {
                name: self._filter_entry(entry["ids"], entry["mode"],
                                         dense_index, impact_index)
                for name, entry in snapshot.items()}
            with self._swap_lock:
                if len(self._filters) != len(snapshot) or any(
                        self._filters.get(n) is not e
                        for n, e in snapshot.items()):
                    continue      # a registration raced us: rebuild
                if new_fused is not None:
                    self._fused = new_fused
                self._filters = new_filters
                self._cmap = new_cmap
                if dense_index is not None:
                    self.dense_index = dense_index
                if impact_index is not None:
                    self.impact_index = impact_index
                return

    @property
    def filter_names(self) -> List[str]:
        return sorted(self._filters)

    # ---- live updates (any thread; the live indexes lock internally) --------
    def _require_live(self, what: str) -> None:
        if not self.live:
            # the JAX package's message, word for word (HTTP bodies match)
            raise ValueError(
                f"{what} requires live indexes — serve LiveDenseIndex / "
                "LiveImpactIndex (index/live.py) instead of static ones")

    def add_documents(self, documents: Sequence[Mapping]) -> int:
        """Add (or replace: the latest wins) documents while serving. Each
        entry is ``{"id": str, "dense": [d] vector, "terms": {key: w}}``
        carrying what the mode needs (both for hybrid). Returns the number
        of distinct ids added. Every document is validated before either
        engine changes, so a rejected batch leaves both engines' doc sets
        as they were; the sparse engine is then updated first."""
        self._require_live("add_documents")
        ids: List[str] = []
        terms_rows: List[Dict] = []
        dense_rows: List[np.ndarray] = []
        for doc in documents:
            if "id" not in doc:
                raise ValueError("every document needs an 'id'")
            ids.append(str(doc["id"]))
            if self._impact_live:
                t = doc.get("terms")
                if not isinstance(t, Mapping) or not t:
                    raise ValueError(
                        f"mode={self.mode!r} documents need non-empty "
                        f"'terms' (doc {doc['id']!r})")
                terms_rows.append(dict(t))
            if self._dense_live:
                d = np.asarray(doc.get("dense"), np.float32).reshape(-1)
                dim = self.dense_index.dim
                if dim is not None and d.shape[0] != dim:
                    raise ValueError(f"doc {doc['id']!r} dense dim "
                                     f"{d.shape[0]} != index dim {dim}")
                dense_rows.append(d)
        if not ids:
            return 0
        dense_arr = None
        if self._dense_live:
            if _PAD_ID in ids:
                raise ValueError("reserved pad id in ids")
            dims = {row.shape[0] for row in dense_rows}
            if len(dims) > 1:   # index dim unset: still refuse ragged input
                raise ValueError(f"inconsistent dense dims within one "
                                 f"batch: {sorted(dims)}")
            dense_arr = np.stack(dense_rows)
        if self._impact_live:
            self.impact_index.add_documents(list(zip(ids, terms_rows)))
        if self._dense_live:
            self.dense_index.add_documents(dense_arr, ids)
        return len(set(ids))

    def delete_documents(self, ids: Sequence[str]) -> int:
        """Tombstone ``ids`` in every live engine; returns the largest
        per-engine hit count (the engines' doc sets agree except
        mid-add)."""
        self._require_live("delete_documents")
        return max(idx.delete_documents(ids)
                   for idx in (self.impact_index, self.dense_index)
                   if idx is not None)

    def compact(self) -> Dict[str, int]:
        """Merge every live engine's segments (minus tombstones) into one;
        returns the per-engine segment counts after."""
        self._require_live("compact")
        out: Dict[str, int] = {}
        if self._impact_live:
            self.impact_index.compact()
            out["sparse_segments"] = self.impact_index.num_segments
        if self._dense_live:
            self.dense_index.compact()
            out["dense_segments"] = self.dense_index.num_segments
        return out

    def save_live(self, directory: Optional[str] = None) -> str:
        """Persist every live engine (one consistent snapshot each) under
        ``directory`` (default: the configured ``live_state_dir``), as
        ``dense/`` and ``sparse/``; ``load_live_state`` restores it."""
        self._require_live("save_live")
        directory = directory or self.live_state_dir
        if directory is None:
            raise ValueError("no directory given and no live_state_dir "
                             "configured")
        if self._dense_live:
            self.dense_index.save(os.path.join(directory, "dense"))
        if self._impact_live:
            self.impact_index.save(os.path.join(directory, "sparse"))
        return directory

    # ---- validation (caller thread) ------------------------------------------
    def _validate(self, terms, dense, depth, text=None, image=None,
                  filter=None) -> QueryRequest:
        depth = self.default_depth if depth is None else int(depth)
        if depth < 1 or depth > self.depth_levels[-1]:
            raise ValueError(f"depth must be in [1, {self.depth_levels[-1]}],"
                             f" got {depth}")
        if filter is not None:
            filter = str(filter)
            if filter not in self._filters:
                raise ValueError(f"unknown filter {filter!r}; registered: "
                                 f"{self.filter_names}")
        if text is not None or image is not None:
            if self.query_encoder is None:
                raise ValueError("text/image queries need a query_encoder")
            if terms is not None or dense is not None:
                raise ValueError("give text/image OR terms/dense, not both")
            if text is not None and image is not None:
                raise ValueError("give text OR image, not both")
            if text is not None:
                if not isinstance(text, str) or not text.strip():
                    raise ValueError("text must be a non-empty string")
                return QueryRequest(None, None, depth, text, filter=filter)
            img = np.asarray(image, np.float32)
            if img.ndim != 3 or img.shape[2] != 3:
                raise ValueError(f"image must be [H, W, 3], got {img.shape}")
            return QueryRequest(None, None, depth, None, img, filter=filter)
        t: Optional[Dict[object, float]] = None
        d: Optional[np.ndarray] = None
        if self.mode in ("sparse", "hybrid"):
            if terms is None:
                raise ValueError(f"mode={self.mode!r} requires terms")
            pairs = terms.items() if isinstance(terms, Mapping) else terms
            t = {}
            for k, w in pairs:
                w = float(w)
                if w > 0:           # non-positive weights drop, as in add()
                    t[k] = t.get(k, 0.0) + w
        if self.mode in ("dense", "hybrid"):
            if dense is None:
                raise ValueError(f"mode={self.mode!r} requires dense")
            d = np.asarray(dense, np.float32).reshape(-1)
            dim = self.dense_index.dim
            if dim is not None and d.shape[0] != dim:
                raise ValueError(f"dense dim {d.shape[0]} != index dim {dim}")
        return QueryRequest(t, d, depth, filter=filter)

    # ---- batch execution (dispatcher thread) ---------------------------------
    def _served_depth(self, reqs: Sequence[QueryRequest]) -> int:
        """Smallest configured level >= the batch's max request depth."""
        need = max(r.depth for r in reqs)
        return self.depth_levels[bisect.bisect_left(self.depth_levels, need)]

    def _encode_media_requests(self, reqs: List[QueryRequest]) -> None:
        """Replace text- and image-carrying requests with their encoded
        terms and dense vector (each kept where its engine is present) —
        ONE fixed-shape encode call per modality for the micro-batch."""
        for sel, encode in (
            ([i for i, r in enumerate(reqs) if r.text is not None],
             lambda xs: self.query_encoder.encode_texts(
                 xs, pad_to=self.device_batch)),
            ([i for i, r in enumerate(reqs) if r.image is not None],
             lambda xs: self.query_encoder.encode_images(
                 xs, pad_to=self.device_batch)),
        ):
            if not sel:
                continue
            dense_vecs, terms_rows = encode(
                [reqs[i].text if reqs[i].text is not None else reqs[i].image
                 for i in sel])
            for j, i in enumerate(sel):
                reqs[i] = replace(
                    reqs[i], text=None, image=None,
                    terms=(self._terms_dict(terms_rows[j])
                           if self.impact_index is not None else None),
                    dense=(dense_vecs[j]
                           if self.dense_index is not None else None))

    def _terms_dict(self, st) -> Dict[object, float]:
        """SelectedTerms -> term dict in the index's id key space, folding
        canonical collisions (sum) when the index was built with them."""
        ids = np.asarray(st.token_ids, np.int64)
        w = np.asarray(st.weights, np.float64)
        if self._cmap is not None:
            ids = np.where(ids < self._cmap.shape[0],
                           self._cmap[np.minimum(ids,
                                                 self._cmap.shape[0] - 1)],
                           -1)
        keep = (ids >= 0) & (w > 0)
        out: Dict[object, float] = {}
        for k, v in zip(ids[keep].tolist(), w[keep].tolist()):
            out[k] = out.get(k, 0.0) + v
        return out

    def _run_batch(self, reqs: List[QueryRequest]):
        # one lock hold for the whole micro-batch (media encode and every
        # filter group): a reload never lands between two groups of a batch
        with self._swap_lock:
            return self._run_batch_locked(reqs)

    def _run_batch_locked(self, reqs: List[QueryRequest]):
        self._encode_media_requests(reqs)
        if any(r.filter is not None for r in reqs):
            # one sub-batch per filter: the mask is one operand of a search,
            # so each distinct filter of a micro-batch is one device call
            groups: Dict[Optional[str], List[int]] = {}
            for i, r in enumerate(reqs):
                groups.setdefault(r.filter, []).append(i)
            out: List = [None] * len(reqs)
            for name, members in groups.items():
                sub = [reqs[i] for i in members]
                for i, row in zip(members, self._run_uniform(sub, name)):
                    out[i] = row
            return out
        return self._run_uniform(reqs, None)

    def _run_uniform(self, reqs: List[QueryRequest],
                     filter_name: Optional[str]):
        flt = self._filters[filter_name] if filter_name is not None else None
        depth = self._served_depth(reqs)
        n = len(reqs)
        if self.mode == "dense":
            scores, ids = self._dense_rows(reqs, depth, flt)
        elif self.mode == "sparse":
            scores, ids = self._sparse_rows(reqs, depth, flt)
        elif self.live or flt is not None or self.fusion_rule == "rrf":
            scores, ids = self._hybrid_rows_host(reqs, depth, flt)
        else:
            q_idx, q_w = self.impact_index.encode_queries(
                self._padded_terms(reqs))
            cand = self.candidate_depth or depth
            scores, ids = self._fused.search_encoded(
                self._padded_dense(reqs), q_idx, q_w, max(cand, depth),
                out_depth=depth)
        return [list(zip(i_row[:r.depth], s_row[:r.depth]))
                for r, s_row, i_row in zip(reqs, scores[:n], ids[:n])]

    def _padded_terms(self, reqs) -> List[Dict[object, float]]:
        return [r.terms for r in reqs] + [{}] * (self.device_batch - len(reqs))

    def _padded_dense(self, reqs) -> np.ndarray:
        q = np.stack([r.dense for r in reqs])
        pad = self.device_batch - len(reqs)
        if pad:
            q = np.concatenate([q, np.zeros((pad, q.shape[1]), q.dtype)])
        return q

    def _dense_rows(self, reqs, depth, flt=None):
        if self._dense_live:
            return self.dense_index.search_rows(
                self._padded_dense(reqs), depth,
                batch_size=self.device_batch)
        scores, ids = self.dense_index.search_ids(
            self._padded_dense(reqs), depth, batch_size=self.device_batch,
            doc_filter=None if flt is None else flt["dense"])
        if flt is not None:
            return scores, ids          # already ragged lists
        return scores.tolist(), ids

    def _sparse_rows(self, reqs, depth, flt=None):
        if self._impact_live:
            return self.impact_index.search_rows(
                self._padded_terms(reqs), depth, backend=self.backend,
                wire=self.wire)
        q_idx, q_w = self.impact_index.encode_queries(self._padded_terms(reqs))
        # the wire holds under filters too: on compact48 an excluded doc's
        # -inf clamps to score 0, which the resolve drops
        return self.impact_index.search_encoded(
            q_idx, q_w, depth, backend=self.backend, wire=self.wire,
            doc_filter=None if flt is None else flt["sparse"])

    def _hybrid_rows_host(self, reqs, depth, flt=None):
        """Host-fused hybrid: each engine's candidate rows at the candidate
        depth, fused by ``search.fusion.fuse`` (or ``fuse_rrf``) itself. A
        doc found by one engine only gets 0 from the other. The sparse
        search runs on the side thread, so both engines' device work and
        copies overlap."""
        cand = max(self.candidate_depth or depth, depth)
        sparse_fut = self._engine_pool.submit(
            self._sparse_rows, reqs, cand, flt)
        d_s, d_i = self._dense_rows(reqs, cand, flt)
        s_s, s_i = sparse_fut.result()
        runs = []
        for rows_s, rows_i in ((d_s, d_i), (s_s, s_i)):
            run = {}
            for q in range(len(reqs)):
                srow, irow = rows_s[q], rows_i[q]
                if len(irow):
                    # rows are score-descending
                    run[str(q)] = {"docs": dict(zip(irow, map(float, srow))),
                                   "max_score": float(srow[0]),
                                   "min_score": float(srow[-1])}
            runs.append(run)
        fuse_fn = fuse_rrf if self.fusion_rule == "rrf" else fuse
        fused = fuse_fn(runs, [self.alpha, 1.0 - self.alpha])
        out_s: List[List[float]] = []
        out_i: List[List[object]] = []
        score_of = operator.itemgetter(1)
        for q in range(len(reqs)):
            ranked = sorted(fused.get(str(q), {}).items(), key=score_of,
                            reverse=True)[:depth]
            out_i.append([doc for doc, _ in ranked])
            out_s.append([sc for _, sc in ranked])
        return out_s, out_i


def load_live_state(directory: str, dense_dtype=None,
                    background_compaction: bool = False, device="cuda"):
    """Restore what :meth:`RetrievalService.save_live` wrote (by either
    package) -> (live dense index or None, live impact index or None), of
    the kind each ``live.json`` names, on ``device``. ``dense_dtype``
    overrides the saved dense dtype (load an f32 save as int8, say);
    ``background_compaction`` is the segment classes' merge scheduler."""
    by_kind = {"dense": LiveDenseIndex, "impact": LiveImpactIndex,
               "dense-arena": ArenaDenseIndex,
               "impact-arena": ArenaImpactIndex}
    dense = impact = None
    d_dir = os.path.join(directory, "dense")
    s_dir = os.path.join(directory, "sparse")
    kw = {"background_compaction": background_compaction, "device": device}
    if os.path.exists(os.path.join(d_dir, "live.json")):
        with open(os.path.join(d_dir, "live.json")) as f:
            kind = json.load(f)["kind"]
        dkw = kw if dense_dtype is None else {"dtype": dense_dtype, **kw}
        dense = by_kind[kind].load(d_dir, **dkw)
    if os.path.exists(os.path.join(s_dir, "live.json")):
        with open(os.path.join(s_dir, "live.json")) as f:
            kind = json.load(f)["kind"]
        impact = by_kind[kind].load(s_dir, **kw)
    if dense is None and impact is None:
        raise FileNotFoundError(f"no live state under {directory}")
    return dense, impact
