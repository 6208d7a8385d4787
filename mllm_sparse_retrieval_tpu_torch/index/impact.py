"""Impact inverted index scored on the card (the JAX package's
``index/impact.py::ImpactIndex``, the subset the online service runs).

Scoring is Lucene's impact sum: a doc's score for a query is
``sum_t q_weight(t) * d_weight(t)`` over shared terms. The host keeps two
layouts, packed doc-major ``[N, K]`` arrays and impact-ordered CSR postings;
the device holds the corpus as a dense ``[T'+1, N_pad]`` impact matrix (row 0
is the query-padding row, term t lives at row t+1), scattered once from the
CSR triples. Two backends give equal scores:

- ``'taat'``: the hand-written CUDA term-at-a-time kernel
  (``ops/impact_kernel.py``), reading only the query's own rows of an int16
  matrix (f32 when a weight is not an integer below 2^15);
- ``'matmul'``: a dense ``[B, T'+1]`` query table times the f32 matrix.

``backend='auto'`` is ``'taat'`` on CUDA and ``'matmul'`` elsewhere. The
index lives on ``device`` (``"cuda"`` unless the caller passes another).
Persistence is the JAX package's ``terms.json`` + ``index.npz`` format, so
an index saved by either package loads in the other. ``from_jsonl`` builds
from the encode pipeline's corpus jsonl, with the native C++ builder
(``index/native``) or the Python one; both give one layout.

``search_encoded(doc_filter=...)`` scopes a search to the docs of an
``index.filter.DocFilter``: the scorer runs unchanged, excluded columns
score -inf before the top-k, and the resolve drops them with the zero
scores, so rows become ragged.

``wire='compact48'`` brings results back as ``packing.pack_topk48`` lanes,
6 bytes a result instead of 8, for integer doc and query weights whose
scores provably stay below 2^24 (``_search_plan`` and ``_check_wire``
check both). ``search_encoded_stream`` / ``search_terms_stream`` keep up to
``lookahead`` chunks in flight across a stream of batches, and ``explain``
breaks one doc's score down by term on the host.

Capacity mode (``doc_capacity`` / ``term_capacity``, set by the arena live
index, ``index/arena.py``) pads the device matrix to the reservation, all
zeros: reserved columns score 0 and the resolve drops them, like docs that
share no query term. ``scatter_append_triples`` writes added documents'
(term, column, weight) triples, or zeros over deleted ones, into every
cached matrix in place, so a search after an add reads the same storage.
Not ported: sharding (ROADMAP Queue 1 #9).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch import hostops as _hostops
from mllm_sparse_retrieval_tpu_torch.ops.packing import (
    unpack_topk, unpack_topk48)
from mllm_sparse_retrieval_tpu_torch.ops.score_programs import (
    _impact_topk, _impact_topk48, _scatter_block, _taat_topk, _taat_topk48)
from mllm_sparse_retrieval_tpu_torch.ops.stream import pipeline_dispatch

TermKey = Union[str, int]
SparseVector = Mapping[TermKey, int]

_DOC_TILE = 2048       # doc-column padding granularity
_PLACE_BLOCK = 4_000_000  # CSR triples per device scatter block
_QUERY_WIDTH_PAD = 64  # query term-count padding granularity
_WIRES = ("i32", "compact48")
# Peak device bytes of one chunk's search per byte of its [B, N_pad] f32
# score tensor (the scores and their masked copy for top-k). chip_smoke.py
# measured 2.01 for both backends on an H100 (B=256, 26,624 doc columns,
# depth 1000); 3 leaves headroom. The JAX package's factor of 6 was a TPU
# top_k measurement and does not carry over.
_SCORE_MEMORY_FACTOR = 3


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _flatten_term_rows(terms_list):
    """Concatenate SelectedTerms rows into flat (token_ids, weights, row)
    arrays — the bulk form every id-keyed path starts from."""
    b = len(terms_list)
    ids = [np.asarray(t.token_ids) for t in terms_list]
    lens = np.fromiter((a.size for a in ids), np.int64, b)
    if b and int(lens.sum()):
        flat_t = np.concatenate(ids)
        flat_w = np.concatenate([np.asarray(t.weights) for t in terms_list])
        if flat_t.dtype.kind not in "iu":
            flat_t = flat_t.astype(np.int64)
    else:
        flat_t = np.empty(0, np.int64)
        flat_w = np.empty(0, np.int64)
    row = np.repeat(np.arange(b, dtype=np.int64), lens)
    return flat_t, flat_w, row


def _apply_canonical(flat_t, canonical_map):
    """Fold token ids through the canonical (lowercase/filter collision)
    map; out-of-range ids become -1 (dropped downstream)."""
    in_rng = (flat_t >= 0) & (flat_t < canonical_map.size)
    return np.where(
        in_rng,
        canonical_map[np.clip(flat_t, 0, canonical_map.size - 1)],
        -1)


class ImpactIndex:
    """Impact-ordered inverted index with batch scoring on the card."""

    # Device-memory guard for the dense scoring matrices: an 80 GB H100
    # serving the 8B text tower in bf16 (16 GB of weights) keeps this much
    # for the index and its score tensors. Copied onto each instance, so
    # ``index.hbm_budget_bytes = ...`` tunes one index only.
    DEFAULT_HBM_BUDGET_BYTES: int = 48 * 10 ** 9

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.hbm_budget_bytes: int = self.DEFAULT_HBM_BUDGET_BYTES
        self.term_to_idx: Dict[TermKey, int] = {}
        self.doc_ids: List[str] = []
        self._doc_vectors: List[SparseVector] = []
        self.doc_terms: Optional[np.ndarray] = None    # int32 [N, K]
        self.doc_weights: Optional[np.ndarray] = None  # float32 [N, K]
        self.csr_offsets: Optional[np.ndarray] = None  # int64 [T+1]
        self.csr_docs: Optional[np.ndarray] = None     # int32 [NNZ]
        self.csr_weights: Optional[np.ndarray] = None  # float32 [NNZ]
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._n_valid = 0
        self._i16_ok: Optional[bool] = None
        # arena capacity (index/arena.py): when set, device matrices are
        # padded to >= doc_capacity columns and term_capacity (+1) rows, and
        # _n_valid covers the whole padded width, so in-place appends
        # (scatter_append_triples) never change a matrix's shape
        self.doc_capacity: Optional[int] = None
        self.term_capacity: Optional[int] = None
        # True iff term ids were canonicalized at build (from_selected_terms
        # with a canonical_map): queries must be folded through the same map
        self.query_canonical: bool = False

    # ---- build ---------------------------------------------------------------
    def add(self, doc_id: str, vector: SparseVector) -> None:
        """Add one document's sparse vector; non-positive weights drop."""
        if self._doc_vectors and self._doc_vectors[0] is None:
            raise RuntimeError(
                "cannot add() to an index restored from disk/packed form — "
                "raw doc vectors were not retained; rebuild it")
        self.doc_ids.append(str(doc_id))
        self._doc_vectors.append(
            {k: int(v) for k, v in vector.items() if int(v) > 0})
        self.doc_terms = None  # invalidate
        self._doc_ids_arr_src = None

    def add_many(self, docs: Iterable[Tuple[str, SparseVector]]) -> None:
        for doc_id, vec in docs:
            self.add(doc_id, vec)

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def num_terms(self) -> int:
        self._ensure_finalized()
        return len(self.term_to_idx)

    def _ensure_finalized(self) -> None:
        if self.doc_terms is None:
            self.finalize()

    def finalize(self) -> None:
        """Assign compact term ids and build packed + CSR layouts."""
        term_to_idx: Dict[TermKey, int] = {}
        for vec in self._doc_vectors:
            for key in vec:
                if key not in term_to_idx:
                    term_to_idx[key] = len(term_to_idx)
        self.term_to_idx = term_to_idx
        n = len(self._doc_vectors)
        k_max = max(max((len(v) for v in self._doc_vectors), default=1), 1)
        doc_terms = np.zeros((n, k_max), dtype=np.int32)
        doc_weights = np.zeros((n, k_max), dtype=np.float32)
        for i, vec in enumerate(self._doc_vectors):
            for j, (key, w) in enumerate(vec.items()):
                doc_terms[i, j] = term_to_idx[key]
                doc_weights[i, j] = w
        self.doc_terms = doc_terms
        self.doc_weights = doc_weights
        self._build_csr()
        self._reorder_terms_by_df()

    def _reorder_terms_by_df(self) -> None:
        """Relabel term ids hot-first (document frequency descending, the
        previous id breaking ties) — the JAX package's order, so both
        packages assign the same ids to the same corpus."""
        t = len(self.term_to_idx)
        if t == 0:
            return
        df = np.diff(self.csr_offsets)
        order = np.argsort(-df, kind="stable")          # new id -> old id
        if np.array_equal(order, np.arange(t)):
            return
        perm = np.empty(t, np.int64)
        perm[order] = np.arange(t)                      # old id -> new id
        keys = list(self.term_to_idx.keys())            # insertion = id order
        self.term_to_idx = {keys[int(o)]: r for r, o in enumerate(order)}
        self.doc_terms = perm[self.doc_terms].astype(np.int32)
        lens = df[order]
        new_offsets = np.zeros(t + 1, dtype=np.int64)
        np.cumsum(lens, out=new_offsets[1:])
        within = np.arange(len(self.csr_docs), dtype=np.int64) - \
            np.repeat(new_offsets[:-1], lens)
        gather = np.repeat(self.csr_offsets[order], lens) + within
        self.csr_docs = self.csr_docs[gather]
        self.csr_weights = self.csr_weights[gather]
        self.csr_offsets = new_offsets
        self._dev = None

    def _build_csr(self) -> None:
        """CSR postings from the packed layout, impact-ordered per term."""
        n, k_max = self.doc_terms.shape
        t = len(self.term_to_idx)
        flat_t = self.doc_terms.reshape(-1)
        flat_w = self.doc_weights.reshape(-1)
        flat_d = np.repeat(np.arange(n, dtype=np.int32), k_max)
        valid = flat_w > 0
        flat_t, flat_w, flat_d = flat_t[valid], flat_w[valid], flat_d[valid]
        order = np.lexsort((-flat_w, flat_t))  # term asc, weight desc
        flat_t, flat_w, flat_d = flat_t[order], flat_w[order], flat_d[order]
        counts = np.bincount(flat_t, minlength=t)
        self.csr_offsets = np.zeros(t + 1, dtype=np.int64)
        np.cumsum(counts, out=self.csr_offsets[1:])
        self.csr_docs = flat_d
        self.csr_weights = flat_w
        self._dev = None
        self._i16_ok = None

    @classmethod
    def from_packed_arrays(cls, doc_terms: np.ndarray,
                           doc_weights: np.ndarray,
                           doc_ids: Optional[Sequence[str]] = None,
                           term_keys: Optional[Sequence[TermKey]] = None,
                           device="cuda") -> "ImpactIndex":
        """Build from packed ``[N, K]`` (term idx, weight) arrays;
        ``term_keys`` defaults to the identity over the observed id range."""
        index = cls(device)
        n = doc_terms.shape[0]
        index.doc_ids = ([str(i) for i in range(n)] if doc_ids is None
                         else [str(d) for d in doc_ids])
        if term_keys is None:
            t = int(doc_terms.max()) + 1 if doc_terms.size else 0
            term_keys = range(t)
        index.term_to_idx = {k: i for i, k in enumerate(term_keys)}
        index.doc_terms = np.asarray(doc_terms, np.int32)
        index.doc_weights = np.asarray(doc_weights, np.float32)
        index._doc_vectors = [None] * n  # type: ignore
        index._build_csr()
        return index

    @classmethod
    def from_selected_terms(cls, doc_ids: Sequence[str],
                            terms_list: Sequence,
                            canonical_map: Optional[np.ndarray] = None,
                            device="cuda") -> "ImpactIndex":
        """Build an int-keyed index straight from per-doc SelectedTerms.

        With ``canonical_map``, string-colliding ids merge last-write-wins
        (the reference's doc dict assembly), then non-positive weights drop
        — the same arithmetic as the string-keyed artifact path."""
        if len(doc_ids) != len(terms_list):
            raise ValueError("doc_ids/terms_list length mismatch")
        n = len(terms_list)
        flat_t, flat_w, row = _flatten_term_rows(terms_list)
        if canonical_map is not None:
            flat_t = _apply_canonical(flat_t, canonical_map)
        keep = flat_t >= 0
        flat_t, flat_w, row = flat_t[keep], flat_w[keep], row[keep]
        # last-write-wins per (doc, term): stable sort by key, keep the
        # final element of each run, THEN drop non-positive weights
        if flat_t.size:
            span = int(flat_t.max()) + 1
            key = row * span + flat_t
            order = np.argsort(key, kind="stable")
            key_s = key[order]
            last = np.empty(key_s.size, bool)
            last[-1] = True
            last[:-1] = key_s[1:] != key_s[:-1]
            sel = order[last]
            sel = sel[flat_w[sel] > 0]
            flat_t, flat_w, row = flat_t[sel], flat_w[sel], row[sel]
        else:
            flat_w = flat_w[:0]
            row = row[:0]
        uniq, compact = np.unique(flat_t, return_inverse=True)
        lens = np.bincount(row, minlength=n) if n else np.zeros(0, np.int64)
        k_max = max(int(lens.max()) if n else 1, 1)
        srt = np.argsort(row, kind="stable")
        row, compact, flat_w = row[srt], compact[srt], flat_w[srt]
        starts = np.cumsum(lens) - lens
        col = np.arange(row.size, dtype=np.int64) - np.repeat(starts, lens)
        doc_terms = np.zeros((n, k_max), np.int32)
        doc_weights = np.zeros((n, k_max), np.float32)
        doc_terms[row, col] = compact
        doc_weights[row, col] = flat_w
        index = cls.from_packed_arrays(
            doc_terms, doc_weights, doc_ids=doc_ids,
            term_keys=[int(u) for u in uniq], device=device)
        index._reorder_terms_by_df()
        index.query_canonical = canonical_map is not None
        return index

    # ---- device placement ----------------------------------------------------
    def _int16_exact(self) -> bool:
        """True when every impact weight is an integer < 2^15, so an int16
        matrix scores exactly like the f32 one at half the bytes."""
        if self._i16_ok is None:
            w = self.csr_weights
            self._i16_ok = bool(
                w is None or w.size == 0 or
                (w.max() < 32767.5 and np.all(w == np.rint(w))))
        return self._i16_ok

    def _materialize(self, dtype: str = "f32") -> torch.Tensor:
        """The dense ``[T'+1, N_pad]`` matrix on this index's device (int16
        for ``'i16'``, f32 for ``'f32'``), scattered from the CSR triples
        and cached per dtype. Row 0 stays zero. In capacity mode the matrix
        has ``max(T, term_capacity) + 1`` rows and at least
        ``doc_capacity`` columns, and every column counts as valid (the
        reserved ones score 0 and are dropped at resolve)."""
        self._ensure_finalized()
        if self._dev is None:
            self._dev = {}
        if dtype in self._dev:
            return self._dev[dtype]
        n = self.doc_terms.shape[0]
        t = max(len(self.term_to_idx), self.term_capacity or 0)
        n_pad = _round_up(max(n, self.doc_capacity or 0, 1), _DOC_TILE)
        self._n_valid = n_pad if self.doc_capacity is not None else n
        itemsize = 2 if dtype == "i16" else 4
        need = (t + 1) * n_pad * itemsize
        cached = sum(d.numel() * d.element_size() for d in self._dev.values())
        if need + cached > self.hbm_budget_bytes:
            raise MemoryError(
                f"impact matrix needs {need / 1e9:.1f} GB (terms={t}, "
                f"docs_pad={n_pad}, {dtype}; {cached / 1e9:.1f} GB already "
                f"cached — drop_device_cache() frees it), over the "
                f"{self.hbm_budget_bytes / 1e9:.1f} GB budget of this index")
        torch_dtype = torch.int16 if dtype == "i16" else torch.float32
        dev = torch.zeros((t + 1, n_pad), dtype=torch_dtype,
                          device=self.device)
        counts = np.diff(self.csr_offsets)
        rows_all = np.repeat(np.arange(counts.size, dtype=np.int64),
                             counts) + 1
        for i in range(0, rows_all.size, _PLACE_BLOCK):
            j = min(i + _PLACE_BLOCK, rows_all.size)
            _scatter_block(
                dev, torch.from_numpy(rows_all[i:j]).to(self.device),
                torch.from_numpy(self.csr_docs[i:j].astype(np.int64)).to(
                    self.device),
                torch.from_numpy(self.csr_weights[i:j]).to(self.device))
        self._dev[dtype] = dev
        return dev

    def drop_device_cache(self) -> None:
        """Release the device matrices (rebuilt on the next search)."""
        self._dev = None

    def scatter_append_triples(self, term_idx, doc_pos, weights) -> None:
        """Write (term idx, doc column, weight) triples into every cached
        device matrix in place: the arena's add and delete primitive
        (``index/arena.py``). Positions and term ids must lie inside the
        capacity reservation. No-op when nothing is materialized yet.

        The triples go in as they are: a (row, col) pair given twice is
        written in an undefined order on CUDA, so callers pass each cell
        once."""
        if not self._dev:
            return
        rows = torch.from_numpy(
            np.asarray(term_idx, np.int64) + 1).to(self.device)
        cols = torch.from_numpy(np.asarray(doc_pos, np.int64)).to(self.device)
        vals = torch.from_numpy(np.asarray(weights, np.float32)).to(
            self.device)
        for dev in self._dev.values():
            _scatter_block(dev, rows, cols, vals)

    # ---- query encoding ------------------------------------------------------
    def encode_queries(self, query_vectors: Sequence[SparseVector],
                       q_max: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Map query dicts to padded (term_idx [B, Qm], weight [B, Qm]).

        Out-of-vocabulary terms and non-positive weights drop; weights are
        truncated to int (``int(w)``); the width pads up to a multiple of
        ``_QUERY_WIDTH_PAD``."""
        import itertools

        self._ensure_finalized()
        b = len(query_vectors)
        lens = np.fromiter((len(v) for v in query_vectors), np.int64, b)
        total = int(lens.sum())
        if total:
            flat_w = np.fromiter(
                (w for vec in query_vectors for w in vec.values()),
                np.float64, total)
            flat_w = np.trunc(flat_w).astype(np.int64)
            get = self.term_to_idx.get
            idx = np.fromiter(
                map(get, (k for vec in query_vectors for k in vec),
                    itertools.repeat(-1, total)), np.int64, total)
        else:
            flat_w = np.empty(0, np.int64)
            idx = np.empty(0, np.int64)
        row = np.repeat(np.arange(b, dtype=np.int64), lens)
        return self._pack_query_rows(b, row, idx, flat_w.astype(np.float64),
                                     q_max)

    def _pack_query_rows(self, b, row, idx, w, q_max):
        """Pack flat (row, term_idx, weight) triples into padded [B, Qm]
        arrays, dropping idx < 0 / w <= 0 and compacting each row left."""
        valid = (idx >= 0) & (w > 0)
        vrow, vidx, vw = row[valid], idx[valid], w[valid]
        vlens = np.bincount(vrow, minlength=b) if b else np.zeros(0, np.int64)
        q_m = max(q_max, int(vlens.max()) if b else 1, 1)
        q_m = _round_up(q_m, _QUERY_WIDTH_PAD)
        starts = np.cumsum(vlens) - vlens
        vcol = np.arange(vrow.size, dtype=np.int64) - \
            np.repeat(starts, vlens)
        out_idx = np.zeros((b, q_m), dtype=np.int32)
        out_w = np.zeros((b, q_m), dtype=np.float32)
        out_idx[vrow, vcol] = vidx
        out_w[vrow, vcol] = vw
        return out_idx, out_w

    @property
    def int_keyed(self) -> bool:
        """True when every term key is an integer token id."""
        self._ensure_finalized()
        if getattr(self, "_int_keyed_src", None) is not self.term_to_idx:
            self._int_keyed = all(
                isinstance(k, (int, np.integer)) and not isinstance(k, bool)
                for k in self.term_to_idx)
            self._int_keyed_src = self.term_to_idx
        return self._int_keyed

    def _term_lut(self) -> np.ndarray:
        """Cached int32 token-id -> compact-term-idx table (-1 = absent)."""
        if getattr(self, "_term_lut_src", None) is not self.term_to_idx:
            if not self.int_keyed:
                raise TypeError(
                    "id-keyed queries need an int-keyed index (build with "
                    "from_selected_terms or integer term keys); this index "
                    "has string term keys — use search()/encode_queries")
            t = len(self.term_to_idx)
            keys = np.fromiter(self.term_to_idx.keys(), np.int64, t)
            if t and keys.min() < 0:
                raise ValueError("negative term key in int-keyed index")
            lut = np.full(int(keys.max()) + 1 if t else 1, -1, np.int32)
            lut[keys] = np.fromiter(self.term_to_idx.values(), np.int64, t)
            self._term_lut_arr = lut
            self._term_lut_src = self.term_to_idx
        return self._term_lut_arr

    def encode_query_terms(self, terms_list: Sequence,
                           canonical_map: Optional[np.ndarray] = None,
                           q_max: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Map SelectedTerms rows to the padded (term_idx, weight) arrays —
        the dict-free counterpart of ``encode_queries`` for int-keyed
        indexes. ``canonical_map`` folds string-colliding ids first;
        duplicate ids within a row add on the device.

        Equal-width batches (the device-select serving shape) stay 2-D:
        dropped entries become (term 0, weight 0) slots, which both backends
        score as padding, so no per-row compaction is needed. Their int32
        rows take the C helpers (``hostops.encode_terms`` without a
        ``canonical_map``, ``hostops.stack_rows`` with one), which give
        the numpy body's arrays."""
        self._ensure_finalized()
        lut = self._term_lut()
        b = len(terms_list)
        first_w = np.asarray(terms_list[0].token_ids).shape[0] if b else 0
        equal = b > 0 and first_w > 0 and all(
            np.asarray(t.token_ids).shape == (first_w,) for t in terms_list)
        if equal:
            flat_t = flat_w = None
            native = _hostops.get()
            if canonical_map is None:
                # one C pass per row: stack, lut gather, OOV / weight masking
                # and pad fill; False = some row is not a contiguous int32
                # buffer of the width
                q_m = _round_up(max(int(q_max), first_w, 1),
                                _QUERY_WIDTH_PAD)
                out_idx = np.empty((b, q_m), np.int32)
                out_w = np.empty((b, q_m), np.float32)
                if native.encode_terms(terms_list, "token_ids", "weights",
                                       lut, first_w, out_idx, out_w):
                    return out_idx, out_w
            # the C row stack; False as above, and the numpy stack runs
            ti = np.empty((b, first_w), np.int32)
            tw = np.empty((b, first_w), np.int32)
            if native.stack_rows(terms_list, "token_ids", "weights", ti, tw):
                flat_t, flat_w = ti, tw
            if flat_t is None:
                flat_t = np.stack([np.asarray(t.token_ids)
                                   for t in terms_list])
                flat_w = np.stack([np.asarray(t.weights)
                                   for t in terms_list])
                if flat_t.dtype.kind not in "iu":
                    flat_t = flat_t.astype(np.int64)
            row = None
        else:
            flat_t, flat_w, row = _flatten_term_rows(terms_list)
        if canonical_map is not None:
            flat_t = _apply_canonical(flat_t, canonical_map)
        in_lut = (flat_t >= 0) & (flat_t < lut.size)
        idx = np.where(in_lut, lut[np.clip(flat_t, 0, lut.size - 1)], -1)
        if equal:
            valid = (idx >= 0) & (flat_w > 0)
            q_m = _round_up(max(int(q_max), first_w, 1), _QUERY_WIDTH_PAD)
            out_idx = np.zeros((b, q_m), np.int32)
            out_w = np.zeros((b, q_m), np.float32)
            out_idx[:, :first_w] = np.where(valid, idx, 0)
            out_w[:, :first_w] = np.where(valid, flat_w, 0)
            return out_idx, out_w
        return self._pack_query_rows(b, row, idx,
                                     flat_w.astype(np.float64), q_max)

    # ---- search --------------------------------------------------------------
    def search_terms(self, terms_list: Sequence, depth: int,
                     canonical_map: Optional[np.ndarray] = None,
                     backend: str = "auto", wire: str = "i32"
                     ) -> Tuple[List[List[float]], List[List[str]]]:
        """Batch impact search straight from SelectedTerms (same result
        contract as ``search``)."""
        q_idx, q_w = self.encode_query_terms(terms_list, canonical_map)
        return self.search_encoded(q_idx, q_w, depth, backend=backend,
                                   wire=wire)

    def search_terms_stream(self, term_batches, depth: int,
                            canonical_map: Optional[np.ndarray] = None,
                            backend: str = "auto", lookahead: int = 3,
                            wire: str = "i32"):
        """Pipelined search over a stream of SelectedTerms batches: one
        ``(scores, ids)`` pair per batch, the numpy encode of batch r+1
        overlapping batch r's device work (``search_encoded_stream``).

        The encode runs inline, not on a prefetch thread: it is Python and
        numpy work that holds the interpreter lock, so a worker thread
        would take the lock from the dispatch path rather than overlap
        with it."""
        encoded = (self.encode_query_terms(batch, canonical_map)
                   for batch in term_batches)
        yield from self.search_encoded_stream(encoded, depth, backend=backend,
                                              lookahead=lookahead, wire=wire)

    def search(self, query_vectors: Sequence[SparseVector], depth: int,
               backend: str = "auto", wire: str = "i32", doc_filter=None
               ) -> Tuple[List[List[float]], List[List[str]]]:
        """Batch impact search: (score lists, ranked doc-id lists), one row
        per query; docs with zero score (and docs ``doc_filter`` excludes)
        are never returned, so rows may be shorter than ``depth``."""
        q_idx, q_w = self.encode_queries(query_vectors)
        return self.search_encoded(q_idx, q_w, depth, backend=backend,
                                   wire=wire, doc_filter=doc_filter)

    def explain(self, terms: SparseVector, doc_id: str) -> Dict:
        """Score breakdown of one (query, doc) pair, on the host, by the
        rules ``search`` scores with: query weights truncated by
        ``int(w)``, non-positive and out-of-vocabulary terms dropped, each
        contribution ``query_weight * doc_weight``.

        Returns ``{"doc_id", "score", "terms": [{"term", "query_weight",
        "doc_weight", "contribution"}, ...] (contribution descending),
        "dropped": [terms that contribute nothing]}``; ``score`` equals the
        engine's score of this doc."""
        self._ensure_finalized()
        if getattr(self, "_doc_pos_src", None) is not self.doc_ids:
            self._doc_pos = {d: i for i, d in enumerate(self.doc_ids)}
            self._doc_pos_src = self.doc_ids
        pos = self._doc_pos.get(str(doc_id))
        if pos is None:
            raise KeyError(f"unknown doc id {doc_id!r}")
        doc_w: Dict[int, float] = {}
        for t, w in zip(self.doc_terms[pos].tolist(),
                        self.doc_weights[pos].tolist()):
            if w > 0:
                doc_w[int(t)] = doc_w.get(int(t), 0.0) + float(w)
        rows = []
        dropped = []
        total = 0.0
        for k, qw in terms.items():
            qw = float(int(qw))
            idx = self.term_to_idx.get(k)
            if qw <= 0 or idx is None or idx not in doc_w:
                dropped.append(k)
                continue
            contribution = qw * doc_w[idx]
            total += contribution
            rows.append({"term": k, "query_weight": qw,
                         "doc_weight": doc_w[idx],
                         "contribution": contribution})
        rows.sort(key=lambda r: -r["contribution"])
        return {"doc_id": str(doc_id), "score": total, "terms": rows,
                "dropped": dropped}

    def search_encoded(self, q_idx: np.ndarray, q_w: np.ndarray, depth: int,
                       backend: str = "auto", wire: str = "i32",
                       doc_filter=None
                       ) -> Tuple[List[List[float]], List[List[str]]]:
        """Search pre-encoded padded query arrays (see ``encode_queries``):
        term ids are this index's compact ids, padding has weight 0.
        ``doc_filter`` (a ``DocFilter`` built against ``doc_ids``) keeps
        only the docs it allows. ``wire='compact48'`` brings the results
        back in 6 bytes each instead of 8 (integer weights only). A batch
        wider than the chunk budget runs in chunks, up to three in
        flight."""
        return next(self.search_encoded_stream(
            [(q_idx, q_w)], depth, backend=backend, wire=wire,
            doc_filter=doc_filter))

    def search_encoded_stream(self, batches, depth: int,
                              backend: str = "auto", lookahead: int = 3,
                              wire: str = "i32", doc_filter=None):
        """Pipelined search: one ``(scores, ids)`` pair per input batch of
        ``(q_idx, q_w)`` arrays (``search_encoded``'s semantics, either
        wire), up to ``lookahead`` chunks in flight ahead of the consumer,
        so batch r+1's upload and scoring overlap batch r's copy back and
        resolve. A batch wider than the chunk budget goes through the same
        pipeline in chunks."""
        plan = self._search_plan(backend, depth, wire, doc_filter)

        def submit():
            seq = 0
            for q_idx, q_w in batches:
                self._check_query_arrays(q_idx, q_w)
                self._check_wire(plan, q_w)
                chunks = list(self._chunk_queries(plan, q_idx, q_w))
                for ci, (chunk_i, chunk_w, take) in enumerate(chunks):
                    yield (chunk_i, chunk_w, take, ci == len(chunks) - 1,
                           seq)
                    seq += 1

        out_s: List[List[float]] = []
        out_i: List[List[str]] = []
        expect_seq = 0

        def dispatch(item):
            chunk_i, chunk_w, take, last, seq = item
            return (self._dispatch_encoded(plan, chunk_i, chunk_w), take,
                    last, seq)

        def resolve(handle):
            nonlocal out_s, out_i, expect_seq
            packed, take, last, seq = handle
            # the rows between two 'last' flags are one batch's only
            # because pipeline_dispatch resolves in submit order
            assert seq == expect_seq, (
                f"stream resolved chunk {seq} out of order "
                f"(expected {expect_seq})")
            expect_seq += 1
            s_c, i_c = self._resolve_encoded(packed, take, plan["wire"])
            out_s.extend(s_c)
            out_i.extend(i_c)
            if last:
                done_s, done_i = out_s, out_i
                out_s, out_i = [], []
                return done_s, done_i
            return None

        yield from pipeline_dispatch(submit(), dispatch, resolve, lookahead)

    # ---- search internals (plan / dispatch / resolve) ------------------------
    def _search_plan(self, backend: str, depth: int, wire: str = "i32",
                     doc_filter=None) -> dict:
        """Resolve backend + wire + device matrix + chunk budget (+ the
        filter's padded device mask) once per search."""
        if backend == "auto":
            backend = "taat" if self.device.type == "cuda" else "matmul"
        if backend not in ("taat", "matmul"):
            raise ValueError(
                f"unknown impact backend {backend!r}: expected 'auto', "
                f"'taat', or 'matmul'")
        if wire not in _WIRES:
            raise ValueError(f"unknown wire {wire!r}: 'i32' or 'compact48'")
        if wire == "compact48" and not self._int16_exact():
            raise ValueError(
                "wire='compact48' needs integer doc weights < 2^15 "
                "(scores must be integers for the 24-bit lane)")
        use_taat = backend == "taat"
        dtype = "i16" if use_taat and self._int16_exact() else "f32"
        dev = self._materialize(dtype)
        n_pad = dev.shape[1]
        if wire == "compact48" and n_pad >= 2 ** 23:
            # the wire's doc-position lane has 23 bits
            raise ValueError(
                f"wire='compact48' supports < 2^23 doc columns (padded "
                f"corpus has {n_pad}); use the i32 wire")
        # the [B, N_pad] f32 score tensor and its top-k working set must fit
        # beside every cached matrix; wide batches chunk
        resident = sum(d.numel() * d.element_size()
                       for d in self._dev.values())
        score_budget = self.hbm_budget_bytes - resident
        per_query = n_pad * 4 * _SCORE_MEMORY_FACTOR
        max_b = max(8, int(score_budget // per_query) // 8 * 8)
        mask = None if doc_filter is None else \
            doc_filter.device_mask(n_pad, dev.device)
        return dict(backend=backend, dev=dev, max_b=max_b,
                    k=min(depth, self._n_valid), wire=wire, mask=mask)

    def _check_wire(self, plan, q_w) -> None:
        """The compact48 wire's query-side proof: integer query weights
        (integer products land on the 24-bit score lane exactly) and a
        bound below 2^24 on every score, or the pack would clamp and
        collapse the top of a ranking into tie order. The bound is the
        largest doc weight times the largest per-query weight sum:
        conservative, exact and O(batch)."""
        if plan["wire"] != "compact48" or q_w.size == 0:
            return
        if not np.all(q_w == np.rint(q_w)):
            raise ValueError("wire='compact48' needs integer query weights "
                             "(got fractional values)")
        if getattr(self, "_max_doc_w_src", None) is not self.doc_weights:
            self._max_doc_w = float(self.doc_weights.max()) \
                if self.doc_weights.size else 0.0
            self._max_doc_w_src = self.doc_weights
        bound = float(np.maximum(q_w, 0).sum(axis=1).max()) * self._max_doc_w
        if bound >= 2 ** 24:
            raise ValueError(
                f"wire='compact48' cannot prove scores < 2^24 for this "
                f"batch (worst-case bound {bound:.4g}); use the i32 wire — "
                f"scores that large are also outside the f32 integer-"
                f"exactness envelope")

    def _check_query_arrays(self, q_idx, q_w) -> None:
        """The query arrays must be one [B, Q] shape (term ids int, weights
        float) holding only this index's term ids."""
        if q_idx.ndim != 2 or q_idx.shape != q_w.shape:
            raise ValueError(f"q_idx {q_idx.shape} and q_w {q_w.shape} must "
                             f"be one [B, Q] shape")
        if q_idx.dtype.kind not in "iu":
            raise TypeError(f"q_idx must be integer, got {q_idx.dtype}")
        live = q_idx[q_w > 0]
        if live.size and (int(live.min()) < 0
                          or int(live.max()) >= len(self.term_to_idx)):
            raise ValueError("q_idx holds term ids outside this index")

    def _chunk_queries(self, plan, q_idx, q_w):
        """Split a batch into dispatchable chunks (chunk_i, chunk_w, take);
        the tail chunk is zero-padded to one shape."""
        b = q_idx.shape[0]
        max_b = plan["max_b"]
        if b <= max_b:
            yield q_idx, q_w, b
            return
        for start in range(0, b, max_b):
            chunk_i = q_idx[start:start + max_b]
            chunk_w = q_w[start:start + max_b]
            if chunk_i.shape[0] < max_b:
                pad_n = max_b - chunk_i.shape[0]
                chunk_i = np.concatenate(
                    [chunk_i, np.zeros((pad_n, chunk_i.shape[1]),
                                       chunk_i.dtype)])
                chunk_w = np.concatenate(
                    [chunk_w, np.zeros((pad_n, chunk_w.shape[1]),
                                       chunk_w.dtype)])
            yield chunk_i, chunk_w, min(max_b, b - start)

    def _compact_queries(self, q_idx, q_w):
        """The int16 upload form of a chunk when it is exact (term ids and
        integer weights below 2^15), half the bytes of int32 / f32; the
        score programs widen it on the device. ``None`` otherwise."""
        if len(self.term_to_idx) >= 32767 or q_idx.size == 0:
            return None
        if np.abs(q_w).max() >= 32767 or not np.all(q_w == np.rint(q_w)):
            return None
        return q_idx.astype(np.int16), q_w.astype(np.int16)

    def _dispatch_encoded(self, plan, q_idx, q_w) -> torch.Tensor:
        """Enqueue one chunk's scoring + top-k; returns the packed device
        tensor (``[B, 2k]`` int32 on the i32 wire, ``[B, 3k]`` int16 lanes
        on compact48) without waiting for it."""
        compact = self._compact_queries(q_idx, q_w)
        if compact is None:
            compact = (np.ascontiguousarray(q_idx, np.int32),
                       np.ascontiguousarray(q_w, np.float32))
        d_idx, d_w = (torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in compact)
        taat = plan["backend"] == "taat"
        if plan["wire"] == "compact48":
            fn = _taat_topk48 if taat else _impact_topk48
        else:
            fn = _taat_topk if taat else _impact_topk
        return fn(plan["dev"], d_idx, d_w, self._n_valid, plan["k"],
                  plan["mask"])

    def _resolve_encoded(self, packed_dev: torch.Tensor, b: int,
                         wire: str = "i32"
                         ) -> Tuple[List[List[float]], List[List[str]]]:
        """Copy one packed result to the host and convert it to ragged
        rows (zero-score docs and filtered-out -inf entries dropped)."""
        unpack = unpack_topk48 if wire == "compact48" else unpack_topk
        scores, idx = unpack(packed_dev[:b].cpu().numpy())
        if getattr(self, "_doc_ids_arr_src", None) is not self.doc_ids or \
                len(self._doc_ids_arr) != len(self.doc_ids):
            self._doc_ids_arr = np.asarray(self.doc_ids)
            self._doc_ids_arr_src = self.doc_ids
        # -inf fill entries may carry any column index; clamp before the
        # fancy index (the score <= 0 drop removes them)
        idx = np.minimum(idx, len(self._doc_ids_arr) - 1)
        ids_rows = self._doc_ids_arr[idx]
        out_scores = scores.tolist()
        out_ids = ids_rows.tolist()
        if scores.size and scores.min() <= 0.0:
            for row in np.nonzero((scores <= 0.0).any(axis=1))[0]:
                pos = scores[row] > 0.0
                out_scores[row] = scores[row][pos].tolist()
                out_ids[row] = ids_rows[row][pos].tolist()
        return out_scores, out_ids

    # ---- persistence ---------------------------------------------------------
    def save(self, directory: str) -> None:
        """Write ``terms.json`` + ``index.npz`` (the JAX package's format)."""
        self._ensure_finalized()
        os.makedirs(directory, exist_ok=True)
        keys = list(self.term_to_idx.keys())
        keys = [int(k) if isinstance(k, np.integer) else k for k in keys]
        with open(os.path.join(directory, "terms.json"), "w") as f:
            json.dump({"keys": keys, "doc_ids": self.doc_ids,
                       "query_canonical": self.query_canonical}, f)
        np.savez(os.path.join(directory, "index.npz"),
                 doc_terms=self.doc_terms, doc_weights=self.doc_weights,
                 csr_offsets=self.csr_offsets, csr_docs=self.csr_docs,
                 csr_weights=self.csr_weights)

    @classmethod
    def from_jsonl(cls, paths: Sequence[str], use_native: bool = True,
                   device="cuda") -> "ImpactIndex":
        """Build from corpus jsonl files (``{"id", "content", "vector":
        {token: weight}}`` a line, what ``write_artifacts`` writes).

        ``use_native=True`` parses, interns, packs and impact-sorts in the
        C++ builder (``index/native``), built at first use; if it cannot be
        built, this raises. ``use_native=False`` takes the Python builder
        (``add`` + ``finalize``). Both give the same layout.
        """
        if use_native:
            from mllm_sparse_retrieval_tpu_torch.index import native
            builder = native.NativeImpactBuilder()
            for path in paths:
                builder.add_jsonl_file(path)
            return cls._from_packed(builder.finalize(), device)
        index = cls(device)
        for path in paths:
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    doc = json.loads(line)
                    index.add(doc["id"], doc["vector"])
        index.finalize()
        return index

    @classmethod
    def _from_packed(cls, packed: dict, device="cuda") -> "ImpactIndex":
        """An index from the native builder's arrays, relabelled
        hot-first like ``finalize``."""
        index = cls(device)
        index.term_to_idx = {k: i for i, k in enumerate(packed["term_keys"])}
        index.doc_ids = list(packed["doc_ids"])
        index.doc_terms = packed["doc_terms"]
        index.doc_weights = packed["doc_weights"]
        index.csr_offsets = packed["csr_offsets"]
        index.csr_docs = packed["csr_docs"]
        index.csr_weights = packed["csr_weights"]
        index._doc_vectors = [None] * len(index.doc_ids)  # type: ignore
        index._reorder_terms_by_df()
        return index

    @classmethod
    def load(cls, directory: str, device="cuda") -> "ImpactIndex":
        """Read an index written by ``save`` (either package)."""
        index = cls(device)
        with open(os.path.join(directory, "terms.json")) as f:
            meta = json.load(f)
        index.term_to_idx = {k: i for i, k in enumerate(meta["keys"])}
        index.doc_ids = [str(d) for d in meta["doc_ids"]]
        index.query_canonical = bool(meta.get("query_canonical", False))
        with np.load(os.path.join(directory, "index.npz")) as data:
            index.doc_terms = data["doc_terms"]
            index.doc_weights = data["doc_weights"]
            index.csr_offsets = data["csr_offsets"]
            index.csr_docs = data["csr_docs"]
            index.csr_weights = data["csr_weights"]
        index._doc_vectors = [None] * len(index.doc_ids)  # type: ignore
        return index
