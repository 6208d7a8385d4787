"""Dense flat MIPS index (the JAX package's ``index/dense.py::
DenseFlatIndex``; FAISS-flat equivalent).

The corpus matrix lives on ``device`` in f32, bf16 or int8 (SQ8) and is
scored by ``ops/mips.py``; queries go in fixed-size chunks, up to three in
flight (``ops/stream.py``). Artifacts are the reference's pickles:
``corpus_{shard}.pkl`` holds ``(np.ndarray [N, d] float32, ids list)``, so
either package loads the other's. ``doc_filter`` (an
``index.filter.DocFilter`` built against ``lookup``) scopes a search to the
docs it allows. ``_materialize(capacity=...)`` and ``write_rows`` are the
arena live index's hooks (``index/arena.py``): a device corpus with zero
rows reserved past the documents, and an in-place write of appended rows
into them.

``mesh=`` (a ``parallel.mesh.Mesh``) on ``search`` / ``batch_search`` /
``search_ids`` splits the corpus by contiguous row blocks over the mesh's
data axis (``_materialize``): the corpus padded with zero rows to a shard
multiple (SQ8: a multiple of ``Q8_ALIGN`` per shard), one block per shard
on its device, scored by ``ops/mips.sharded_mips_topk`` and merged on the
mesh's lead device. The mesh chunk programs return ``(scores, idx)``
rather than a packed tensor. The placement is cached per mesh object.
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
    DTYPES, Q8_ALIGN, mips_topk_packed, mips_topk_packed_q8,
    sharded_mips_topk, sharded_mips_topk_q8)
from mllm_sparse_retrieval_tpu_torch.ops.packing import unpack_topk
from mllm_sparse_retrieval_tpu_torch.ops.stream import pipeline_dispatch
from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    DATA_AXIS, replicated, shard_batch)


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
        # one tensor, or under a mesh one block per data shard
        self._corpus_dev = None
        self._row_scale_dev = None
        self._mesh = None
        self._n_pad = 0        # placed rows, padding included
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

    def _materialize(self, capacity: Optional[int] = None,
                     mesh=None) -> None:
        """Place the corpus on the device, once per mesh (a search under
        another mesh, or none, re-places it). With ``capacity`` (the
        arena's reservation) the device corpus has ``max(size, capacity)``
        rows, the ones past the documents zero, and every row counts as
        valid: the arena's live mask keeps the reserved ones out. Under a
        ``mesh`` the rows pad with zeros to a multiple of the data axis (of
        ``data * Q8_ALIGN`` for SQ8) and split into one contiguous block
        per shard on its device."""
        if self._corpus_dev is not None and self._mesh is mesh:
            return
        corpus = self._host_corpus() if self._chunks else \
            np.zeros((0, self.dim or 0), np.float32)
        n = corpus.shape[0]
        rows = max(n, capacity or 0)
        self._n_valid = rows if capacity is not None else n
        self._mesh = mesh
        n_shards = 1 if mesh is None else mesh.shape[DATA_AXIS]
        if not self.q8:
            if mesh is None:
                dev = torch.from_numpy(corpus).to(self.device).to(self.dtype)
                if rows > n:
                    dev = torch.cat([dev, dev.new_zeros((rows - n,
                                                         dev.shape[1]))])
                self._corpus_dev = dev
                self._n_pad = rows
                return
            padded = np.zeros((-(-max(rows, 1) // n_shards) * n_shards,
                               corpus.shape[1]), np.float32)
            padded[:n] = corpus
            self._corpus_dev = [s.to(self.dtype)
                                for s in shard_batch(mesh, padded)]
            self._n_pad = padded.shape[0]
            return
        q8, scale = self._quantize_rows(corpus)
        d = q8.shape[1]
        align = Q8_ALIGN * n_shards
        padded = np.zeros((-(-max(rows, 1) // align) * align,
                           -(-max(d, 1) // Q8_ALIGN) * Q8_ALIGN), np.int8)
        padded[:n, :d] = q8
        scales = np.ones(padded.shape[0], np.float32)
        scales[:n] = scale
        if capacity is not None:
            self._n_valid = padded.shape[0]
        self._n_pad = padded.shape[0]
        if mesh is None:
            self._corpus_dev = torch.from_numpy(padded).to(self.device)
            self._row_scale_dev = torch.from_numpy(scales).to(self.device)
        else:
            self._corpus_dev = shard_batch(mesh, padded)
            self._row_scale_dev = shard_batch(mesh, scales)

    def write_rows(self, reps: np.ndarray, start: int) -> None:
        """Write ``reps [m, d]`` into device corpus rows ``start ..
        start + m`` in place (SQ8: quantized rows and their scales), the
        arena's append. The rows must lie inside the placed corpus; no-op
        when the corpus is not placed."""
        if self._corpus_dev is None:
            return
        reps = np.ascontiguousarray(reps, np.float32)
        m, d = reps.shape
        if start + m > self._n_pad:
            raise ValueError(f"rows {start}..{start + m} past the placed "
                             f"corpus of {self._n_pad}")
        if self.q8:
            reps, scale = self._quantize_rows(reps)
        blocks = self._corpus_dev if self._mesh is not None \
            else [self._corpus_dev]
        scales = self._row_scale_dev if self._mesh is not None \
            else [self._row_scale_dev]
        shard_rows = blocks[0].shape[0]
        # a row range may straddle shards: write each shard's part
        for b in range(start // shard_rows,
                       (start + m - 1) // shard_rows + 1 if m else 0):
            lo = max(start, b * shard_rows)
            hi = min(start + m, (b + 1) * shard_rows)
            dst = blocks[b]
            part = torch.from_numpy(reps[lo - start:hi - start]).to(
                dst.device)
            local = slice(lo - b * shard_rows, hi - b * shard_rows)
            dst[local, :d] = part.to(dst.dtype)
            if self.q8:
                scales[b][local] = torch.from_numpy(
                    scale[lo - start:hi - start]).to(dst.device)

    # ---- search --------------------------------------------------------------
    def _dispatch_chunk(self, chunk: np.ndarray, depth: int, mask=None):
        """Enqueue one chunk's scoring with no host sync. Returns the
        packed ``[B, 2k]`` int32 device tensor, or under the placement's
        mesh ``(scores [B, k], idx [B, k])`` on its lead device. Queries
        travel in the corpus dtype (half the bytes for bf16; SQ8 queries
        are quantized per row on the host, a quarter). ``mask`` (from
        ``DocFilter.device_mask``, per shard under a mesh) scores excluded
        rows -inf."""
        chunk = np.ascontiguousarray(chunk, np.float32)
        mesh = self._mesh
        if self.q8:
            q8, q_scale = self._quantize_rows(chunk)
            width = (self._corpus_dev[0] if mesh is not None
                     else self._corpus_dev).shape[1]
            if q8.shape[1] < width:
                q8 = np.pad(q8, ((0, 0), (0, width - q8.shape[1])))
            q8 = np.ascontiguousarray(q8)
            if mesh is not None:
                return sharded_mips_topk_q8(
                    mesh, replicated(mesh, q8), replicated(mesh, q_scale),
                    self._corpus_dev, self._row_scale_dev, self._n_valid,
                    depth, mask)
            return mips_topk_packed_q8(
                torch.from_numpy(q8).to(self.device),
                torch.from_numpy(q_scale).to(self.device), self._corpus_dev,
                self._row_scale_dev, depth, self._n_valid, mask)
        if mesh is not None:
            return sharded_mips_topk(
                mesh, [q.to(self.dtype) for q in replicated(mesh, chunk)],
                self._corpus_dev, self._n_valid, depth, mask)
        q = torch.from_numpy(chunk).to(self.device).to(self.dtype)
        return mips_topk_packed(q, self._corpus_dev, depth, mask)

    @staticmethod
    def _resolve_chunk(out) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(out, tuple):          # mesh form: (scores, idx)
            return out[0].cpu().numpy(), out[1].cpu().numpy()
        return unpack_topk(out.cpu().numpy())

    def _mask(self, doc_filter):
        if doc_filter is None:
            return None
        return doc_filter.device_mask(
            self._n_pad, self.device if self._mesh is None else self._mesh)

    def search(self, q_reps: np.ndarray, depth: int, doc_filter=None,
               mesh=None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-``depth`` MIPS: (scores [B, k] f32, row indices
        [B, k]), ``k = min(depth, size)``. Rows ``doc_filter`` excludes
        come back as score -inf (``search_ids`` drops them). ``mesh``
        row-shards the corpus over its data axis."""
        self._materialize(mesh=mesh)
        return self._resolve_chunk(self._dispatch_chunk(
            np.asarray(q_reps, np.float32), depth, self._mask(doc_filter)))

    def batch_search(self, q_reps: np.ndarray, depth: int,
                     batch_size: int = 128, lookahead: int = 3,
                     doc_filter=None, mesh=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """``search`` in chunks of ``batch_size`` queries (the last one
        zero-padded to that size), up to ``lookahead`` chunks in flight."""
        self._materialize(mesh=mesh)
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
            scores, idx = self._resolve_chunk(out)
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
                   batch_size: int = 128, doc_filter=None, mesh=None):
        """``batch_search`` with row indices mapped to lookup ids:
        (scores [B, k] f32, id rows). With ``doc_filter`` both are ragged
        lists: a row drops its -inf entries where fewer than ``depth``
        allowed docs exist (the sparse engine's zero-score rule)."""
        scores, idx = self.batch_search(q_reps, depth, batch_size, mesh=mesh,
                                        doc_filter=doc_filter)
        if self._lookup_arr_src is not self.lookup or \
                len(self._lookup_arr) != len(self.lookup):
            self._lookup_arr = np.asarray(self.lookup)
            self._lookup_arr_src = self.lookup
        # a -inf fill entry (a filter allowing fewer than depth docs) may
        # carry a padding row; the keep mask below drops it
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
