"""Transport-free retrieval service, sparse mode: validated queries ->
micro-batched device calls (the JAX package's ``serving/service.py``, the
sparse engine with live text and image encoding).

Concurrent single queries coalesce in a :class:`MicroBatcher` into one
encode + search per micro-batch. Depths are quantized up to fixed levels
and each request's result is cut back to what it asked for. Dense and
hybrid modes, live indexes, doc filters and reloads wait for later slices.
"""

from __future__ import annotations

import bisect
from concurrent.futures import Future
from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from mllm_sparse_retrieval_tpu_torch.serving.batcher import MicroBatcher
from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
    canonical_id_map)

TermsLike = Union[Mapping[object, float], Sequence[Tuple[object, float]]]


@dataclass(frozen=True)
class QueryRequest:
    """One validated query: ``terms`` keyed by the impact index's key space,
    or raw ``text`` or ``image`` (needs a ``query_encoder``), and the
    requested ``depth``."""
    terms: Optional[Dict[object, float]]
    depth: int
    text: Optional[str] = None
    image: Optional[np.ndarray] = None   # raw [H, W, 3] float in [0, 1]


class RetrievalService:
    """Micro-batched sparse retrieval over a prebuilt :class:`ImpactIndex`.

    ``search`` / ``search_async`` are thread-safe; each call is one query.
    Requests are validated on the caller's thread so malformed input never
    poisons a batch. ``close()`` stops the dispatcher thread.
    """

    def __init__(self, impact_index, *,
                 depth_levels: Sequence[int] = (10, 100, 1000),
                 default_depth: int = 10, backend: str = "auto",
                 max_batch: int = 256,
                 max_wait_ms: float = 4.0,
                 device_batch: Optional[int] = None, query_encoder=None):
        if impact_index is None:
            raise ValueError("need an impact_index")
        self.impact_index = impact_index
        self.mode = "sparse"
        self.depth_levels = tuple(sorted(set(int(d) for d in depth_levels)))
        if any(d < 1 for d in self.depth_levels):
            raise ValueError(f"depth_levels must be >= 1: {depth_levels}")
        self.default_depth = int(default_depth)
        if self.default_depth > self.depth_levels[-1]:
            raise ValueError("default_depth exceeds max depth level")
        self.backend = backend
        # every micro-batch is padded to this fixed device batch, so the
        # encoder and the search always see one shape
        self.device_batch = int(device_batch or max_batch)
        if self.device_batch < max_batch:
            raise ValueError("device_batch must be >= max_batch")
        self.query_encoder = query_encoder
        self._cmap = self._build_cmap(impact_index)
        self._batcher = MicroBatcher(self._run_batch, max_batch=max_batch,
                                     max_wait_ms=max_wait_ms,
                                     name="retrieval-batcher")

    # ---- public API ----------------------------------------------------------
    def search_async(self, terms: Optional[TermsLike] = None,
                     depth: Optional[int] = None,
                     text: Optional[str] = None, image=None) -> Future:
        return self._batcher.submit(self._validate(terms, depth, text,
                                                   image))

    def search(self, terms: Optional[TermsLike] = None,
               depth: Optional[int] = None, text: Optional[str] = None,
               image=None, timeout: Optional[float] = 60.0):
        """Blocking single query -> list of ``(doc_id, score)``,
        score-descending, at most ``depth`` entries. Give ``text`` or
        ``image`` (a raw ``[H, W, 3]`` float array in [0, 1], any size;
        encoded live, needs a ``query_encoder``) or explicit ``terms``."""
        return self.search_async(terms, depth, text, image).result(timeout)

    def stats(self) -> Dict[str, float]:
        s = self._batcher.stats()
        s["mode"] = self.mode
        return s

    def close(self) -> None:
        self._batcher.close()

    def _build_cmap(self, impact_index):
        """The query canonical map: applied iff the index was BUILT with
        canonical id-collision merges (``query_canonical``)."""
        if (self.query_encoder is None
                or not getattr(impact_index, "query_canonical", False)):
            return None
        return canonical_id_map(self.query_encoder.tokenizer.get_vocab(),
                                self.query_encoder.sparse_cfg.is_filtered)

    # ---- validation (caller thread) ------------------------------------------
    def _validate(self, terms, depth, text=None, image=None) -> QueryRequest:
        depth = self.default_depth if depth is None else int(depth)
        if depth < 1 or depth > self.depth_levels[-1]:
            raise ValueError(f"depth must be in [1, {self.depth_levels[-1]}],"
                             f" got {depth}")
        if text is not None or image is not None:
            if self.query_encoder is None:
                raise ValueError("text/image queries need a query_encoder")
            if terms is not None:
                raise ValueError("give text/image OR terms, not both")
            if text is not None and image is not None:
                raise ValueError("give text OR image, not both")
            if text is not None:
                if not isinstance(text, str) or not text.strip():
                    raise ValueError("text must be a non-empty string")
                return QueryRequest(None, depth, text)
            img = np.asarray(image, np.float32)
            if img.ndim != 3 or img.shape[2] != 3:
                raise ValueError(f"image must be [H, W, 3], got {img.shape}")
            return QueryRequest(None, depth, None, img)
        if terms is None:
            raise ValueError("mode='sparse' requires terms, text or image")
        pairs = terms.items() if isinstance(terms, Mapping) else terms
        t: Dict[object, float] = {}
        for k, w in pairs:
            w = float(w)
            if w > 0:           # non-positive weights drop, as in add()
                t[k] = t.get(k, 0.0) + w
        return QueryRequest(t, depth)

    # ---- batch execution (dispatcher thread) ---------------------------------
    def _served_depth(self, reqs: Sequence[QueryRequest]) -> int:
        """Smallest configured level >= the batch's max request depth."""
        need = max(r.depth for r in reqs)
        return self.depth_levels[bisect.bisect_left(self.depth_levels, need)]

    def _encode_media_requests(self, reqs: List[QueryRequest]) -> None:
        """Replace text- and image-carrying requests with their encoded
        terms — ONE fixed-shape encode call per modality for the whole
        micro-batch."""
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
            _, terms_rows = encode(
                [reqs[i].text if reqs[i].text is not None else reqs[i].image
                 for i in sel])
            for j, i in enumerate(sel):
                reqs[i] = replace(reqs[i], text=None, image=None,
                                  terms=self._terms_dict(terms_rows[j]))

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
        self._encode_media_requests(reqs)
        return self._run_uniform(reqs)

    def _run_uniform(self, reqs: List[QueryRequest]):
        depth = self._served_depth(reqs)
        n = len(reqs)
        scores, ids = self._sparse_rows(reqs, depth)
        return [list(zip(i_row[:r.depth], s_row[:r.depth]))
                for r, s_row, i_row in zip(reqs, scores[:n], ids[:n])]

    def _padded_terms(self, reqs) -> List[Dict[object, float]]:
        return [r.terms for r in reqs] + [{}] * (self.device_batch - len(reqs))

    def _sparse_rows(self, reqs, depth):
        q_idx, q_w = self.impact_index.encode_queries(self._padded_terms(reqs))
        return self.impact_index.search_encoded(
            q_idx, q_w, depth, backend=self.backend)
