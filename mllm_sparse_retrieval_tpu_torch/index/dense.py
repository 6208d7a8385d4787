"""Dense flat MIPS index on one device (the JAX package's
``index/dense.py::DenseFlatIndex``; FAISS-flat equivalent).

The corpus matrix lives on ``device`` in f32, bf16 or int8 (SQ8) and is
scored by ``ops/mips.py``; queries go in fixed-size chunks, up to three in
flight (``ops/stream.py``). Artifacts are the reference's pickles:
``corpus_{shard}.pkl`` holds ``(np.ndarray [N, d] float32, ids list)``, so
either package loads the other's. ``doc_filter`` (an
``index.filter.DocFilter`` built against ``lookup``) scopes a search to the
docs it allows. ``_materialize(capacity=...)`` and ``write_rows`` are the
arena live index's hooks (``index/arena.py``): a device corpus with zero
rows reserved past the documents, and an in-place write of appended rows
into them. Not ported: meshes (ROADMAP Queue 1 #9).
"""

from __future__ import annotations

import collections
import glob
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.ops.mips import (
    DTYPES, Q8_ALIGN, mips_topk_packed, mips_topk_packed_q8)
from mllm_sparse_retrieval_tpu_torch.ops.packing import unpack_topk
from mllm_sparse_retrieval_tpu_torch.ops.stream import pipeline_dispatch


class DenseFlatIndex:
    """Exact inner-product search over a corpus embedding matrix.

    ``dtype=torch.bfloat16`` keeps the device corpus (and the queries) in
    bf16, half the device bytes, with f32 accumulation and f32 scores, so
    near-ties can rank differently from the f32 index.

    ``dtype=torch.int8`` (or ``"int8"``) is scalar quantization (SQ8):
    symmetric per-row int8 corpus values with f32 row scales, queries
    quantized per row on the host, an exact int8 x int8 -> int32 product,
    and f32 scores dequantized by the scale outer product before the top-k:
    a quarter of the f32 device bytes. A positive per-query scale cannot
    change that query's ranking, so the only error is the int8 rounding of
    the inputs. The device corpus is padded with zero rows and columns to
    multiples of ``Q8_ALIGN`` (the card's int8 product needs them), and the
    padding rows never rank. Saved pickles stay f32 for every dtype.
    """

    def __init__(self, dim: Optional[int] = None, dtype=torch.float32,
                 device="cuda"):
        self.q8 = dtype == "int8" or dtype == torch.int8
        if self.q8:
            dtype = torch.int8
        elif dtype not in DTYPES:
            raise TypeError(f"dense dtype {dtype}: float32, bfloat16 or "
                            f"int8")
        self.dim = dim
        self.dtype = dtype
        self.device = torch.device(device)
        self._chunks: List[np.ndarray] = []
        self.lookup: List[str] = []
        self._corpus_dev: Optional[torch.Tensor] = None
        self._row_scale_dev: Optional[torch.Tensor] = None
        self._n_valid = 0
        self._lookup_arr_src = None

    # ---- construction ------------------------------------------------------
    def add(self, reps: np.ndarray, ids: Sequence) -> None:
        reps = np.asarray(reps, dtype=np.float32)
        if reps.ndim != 2:
            raise ValueError(f"reps must be [N, d], got {reps.shape}")
        if self.dim is None:
            self.dim = reps.shape[1]
        if reps.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {reps.shape[1]} != {self.dim}")
        if len(ids) != reps.shape[0]:
            raise ValueError("ids/reps length mismatch")
        self._chunks.append(reps)
        self.lookup.extend(str(i) for i in ids)
        self._corpus_dev = None
        self._row_scale_dev = None
        self._lookup_arr_src = None

    @property
    def size(self) -> int:
        return len(self.lookup)

    @staticmethod
    def _quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Symmetric per-row int8 quantization: (int8 values, f32 scales)
        with ``values * scale[:, None] ~= x``. An all-zero row gets scale 1
        (its values are zero either way)."""
        scale = np.abs(x).max(axis=1) / 127.0 if x.size else \
            np.zeros(x.shape[0], np.float32)
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
        return q, scale

    def _host_corpus(self) -> np.ndarray:
        return np.concatenate(self._chunks) if len(self._chunks) != 1 \
            else self._chunks[0]

    def _materialize(self, capacity: Optional[int] = None) -> None:
        """Place the corpus on the device, once. With ``capacity`` (the
        arena's reservation) the device corpus has ``max(size, capacity)``
        rows, the ones past the documents zero, and every row counts as
        valid: the arena's live mask keeps the reserved ones out."""
        if self._corpus_dev is not None:
            return
        corpus = self._host_corpus() if self._chunks else \
            np.zeros((0, self.dim or 0), np.float32)
        n = corpus.shape[0]
        rows = max(n, capacity or 0)
        self._n_valid = rows if capacity is not None else n
        if not self.q8:
            dev = torch.from_numpy(corpus).to(self.device).to(self.dtype)
            if rows > n:
                dev = torch.cat([dev, dev.new_zeros((rows - n, dev.shape[1]))])
            self._corpus_dev = dev
            return
        q8, scale = self._quantize_rows(corpus)
        d = q8.shape[1]
        padded = np.zeros((-(-max(rows, 1) // Q8_ALIGN) * Q8_ALIGN,
                           -(-max(d, 1) // Q8_ALIGN) * Q8_ALIGN), np.int8)
        padded[:n, :d] = q8
        scales = np.ones(padded.shape[0], np.float32)
        scales[:n] = scale
        if capacity is not None:
            self._n_valid = padded.shape[0]
        self._corpus_dev = torch.from_numpy(padded).to(self.device)
        self._row_scale_dev = torch.from_numpy(scales).to(self.device)

    def write_rows(self, reps: np.ndarray, start: int) -> None:
        """Write ``reps [m, d]`` into device corpus rows ``start ..
        start + m`` in place (SQ8: quantized rows and their scales), the
        arena's append. The rows must lie inside the placed corpus; no-op
        when the corpus is not placed."""
        if self._corpus_dev is None:
            return
        reps = np.ascontiguousarray(reps, np.float32)
        m, d = reps.shape
        if start + m > self._corpus_dev.shape[0]:
            raise ValueError(f"rows {start}..{start + m} past the placed "
                             f"corpus of {self._corpus_dev.shape[0]}")
        if not self.q8:
            self._corpus_dev[start:start + m] = torch.from_numpy(reps).to(
                self.device).to(self.dtype)
            return
        q8, scale = self._quantize_rows(reps)
        self._corpus_dev[start:start + m, :d] = torch.from_numpy(q8).to(
            self.device)
        self._row_scale_dev[start:start + m] = torch.from_numpy(scale).to(
            self.device)

    # ---- search --------------------------------------------------------------
    def _dispatch_chunk(self, chunk: np.ndarray, depth: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Enqueue one chunk's scoring and return the packed ``[B, 2k]``
        int32 device tensor, with no host sync. Queries travel in the
        corpus dtype (half the bytes for bf16; SQ8 queries are quantized
        per row on the host, a quarter). ``mask`` (a device bool ``[N]``
        from ``DocFilter.device_mask``) scores excluded rows -inf."""
        chunk = np.ascontiguousarray(chunk, np.float32)
        if self.q8:
            q8, q_scale = self._quantize_rows(chunk)
            width = self._corpus_dev.shape[1]
            if q8.shape[1] < width:
                q8 = np.pad(q8, ((0, 0), (0, width - q8.shape[1])))
            return mips_topk_packed_q8(
                torch.from_numpy(np.ascontiguousarray(q8)).to(self.device),
                torch.from_numpy(q_scale).to(self.device), self._corpus_dev,
                self._row_scale_dev, depth, self._n_valid, mask)
        q = torch.from_numpy(chunk).to(self.device).to(self.dtype)
        return mips_topk_packed(q, self._corpus_dev, depth, mask)

    def _mask(self, doc_filter) -> Optional[torch.Tensor]:
        return None if doc_filter is None else doc_filter.device_mask(
            self._corpus_dev.shape[0], self.device)

    def search(self, q_reps: np.ndarray, depth: int, doc_filter=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-``depth`` MIPS: (scores [B, k] f32, row indices
        [B, k]), ``k = min(depth, size)``. Rows ``doc_filter`` excludes
        come back as score -inf (``search_ids`` drops them)."""
        self._materialize()
        return unpack_topk(self._dispatch_chunk(
            np.asarray(q_reps, np.float32), depth,
            self._mask(doc_filter)).cpu().numpy())

    def batch_search(self, q_reps: np.ndarray, depth: int,
                     batch_size: int = 128, lookahead: int = 3,
                     doc_filter=None) -> Tuple[np.ndarray, np.ndarray]:
        """``search`` in chunks of ``batch_size`` queries (the last one
        zero-padded to that size), up to ``lookahead`` chunks in flight."""
        self._materialize()
        q_reps = np.asarray(q_reps, dtype=np.float32)
        n = q_reps.shape[0]
        all_scores, all_idx = [], []
        mask = self._mask(doc_filter)

        def chunks():
            for start in range(0, n, batch_size):
                chunk = q_reps[start:start + batch_size]
                valid = chunk.shape[0]
                if valid < batch_size:
                    chunk = np.concatenate(
                        [chunk, np.zeros((batch_size - valid,
                                          chunk.shape[1]), chunk.dtype)])
                yield chunk, valid

        def dispatch(item):
            chunk, valid = item
            return self._dispatch_chunk(chunk, depth, mask), valid

        def resolve(handle):
            out, valid = handle
            scores, idx = unpack_topk(out.cpu().numpy())
            all_scores.append(scores[:valid])
            all_idx.append(idx[:valid])

        collections.deque(
            pipeline_dispatch(chunks(), dispatch, resolve, lookahead),
            maxlen=0)
        if not all_scores:
            k = min(depth, self._n_valid)
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        return np.concatenate(all_scores), np.concatenate(all_idx)

    def search_ids(self, q_reps: np.ndarray, depth: int,
                   batch_size: int = 128, doc_filter=None):
        """``batch_search`` with row indices mapped to lookup ids:
        (scores [B, k] f32, id rows). With ``doc_filter`` both are ragged
        lists: a row drops its -inf entries where fewer than ``depth``
        allowed docs exist (the sparse engine's zero-score rule)."""
        scores, idx = self.batch_search(q_reps, depth, batch_size,
                                        doc_filter=doc_filter)
        if self._lookup_arr_src is not self.lookup or \
                len(self._lookup_arr) != len(self.lookup):
            self._lookup_arr = np.asarray(self.lookup)
            self._lookup_arr_src = self.lookup
        # a -inf fill entry (a filter allowing fewer than depth docs) may
        # carry an SQ8 padding row; the keep mask below drops it
        idx = np.minimum(idx, len(self._lookup_arr) - 1)
        ids = self._lookup_arr[idx].tolist()
        if doc_filter is None:
            return scores, ids
        keep = scores > -np.inf
        return ([s[k].tolist() for s, k in zip(scores, keep)],
                [[d for d, kk in zip(row, k) if kk]
                 for row, k in zip(ids, keep)])

    # ---- persistence -----------------------------------------------------------
    def save_shard(self, path: str) -> None:
        """Write the reference's ``(embeddings, lookup_ids)`` pickle."""
        corpus = self._host_corpus() if self._chunks else \
            np.zeros((0, self.dim or 0), np.float32)
        with open(path, "wb") as f:
            pickle.dump((corpus, list(self.lookup)), f)

    @classmethod
    def load(cls, path_or_dir: str, dtype=torch.float32,
             device="cuda") -> "DenseFlatIndex":
        """Load a ``corpus*.pkl`` file, a directory of them (else of any
        ``*.pkl``), or ``query.pkl``."""
        if os.path.isdir(path_or_dir):
            files = sorted(glob.glob(os.path.join(path_or_dir,
                                                  "corpus*.pkl")))
            if not files:
                files = sorted(glob.glob(os.path.join(path_or_dir, "*.pkl")))
            if not files:
                raise FileNotFoundError(f"no *.pkl shards under "
                                        f"{path_or_dir}")
        else:
            files = [path_or_dir]
        index = cls(dtype=dtype, device=device)
        for fp in files:
            with open(fp, "rb") as f:
                reps, lookup = pickle.load(f)
            index.add(np.asarray(reps), lookup)
        return index
