"""Approximate dense index: low-rank prefilter + exact rescore
(``ops/ann.py``; the JAX package's ``index/ann.py``).

``DenseANNIndex`` is a :class:`DenseFlatIndex` (the same ``add`` /
``search_ids`` / ``batch_search`` and pickle artifacts) whose device
placement and per-chunk program are swapped: a ``rank/d``-cost stage 1
picks ``candidates`` rows per query, and a full-precision rescore gives
their scores, so the results differ from the exact index's only where a
true top-k row was not among the candidates. Under a mesh the projected
rows shard like the corpus rows and ``candidates`` applies per shard
(``ops/ann.sharded_ann_topk``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.ops.ann import (
    ann_topk_packed, ip_projection, sharded_ann_topk)
from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    replicated, shard_batch)


class DenseANNIndex(DenseFlatIndex):
    """Approximate-candidate, exact-score MIPS index.

    Arguments beyond ``DenseFlatIndex``:
      rank: stage-1 projection width (stage 1 costs ``rank/d`` of the exact
        product).
      candidates: rescored rows per query, raised to the requested depth
        and capped at the corpus size at search time.
      recall_target: the JAX package's ``approx_max_k`` knob, accepted for
        parity; the port's stage-1 selection is exact.
      train_sample: most rows used for the projection basis.
      seed: draws the ``train_sample`` rows.

    ``dtype`` is f32 or bf16 (the rescore gathers rows of that dtype). SQ8
    is the exact index's trade: an int8 corpus is refused here.
    """

    def __init__(self, dim: Optional[int] = None, dtype=torch.float32,
                 device="cuda", *, rank: int = 64, candidates: int = 1024,
                 recall_target: float = 0.95, train_sample: int = 65536,
                 seed: int = 0):
        if dtype == "int8" or dtype == torch.int8:
            raise ValueError("DenseANNIndex does not support int8 corpora; "
                             "use DenseFlatIndex(dtype=int8) for the SQ8 "
                             "trade or bf16 here")
        super().__init__(dim, dtype, device)
        self.rank = int(rank)
        self.candidates = int(candidates)
        self.recall_target = float(recall_target)
        self.train_sample = int(train_sample)
        self.seed = int(seed)
        self._proj: Optional[np.ndarray] = None            # [d, r] host
        self._proj_dev: Optional[torch.Tensor] = None
        self._corpus_r_dev: Optional[torch.Tensor] = None

    def _materialize(self, capacity: Optional[int] = None,
                     mesh=None) -> None:
        fresh = self._corpus_dev is None or self._mesh is not mesh
        super()._materialize(capacity, mesh)
        if not fresh and self._corpus_r_dev is not None:
            return
        corpus = self._host_corpus()
        if self._proj is None or self._proj.shape[0] != corpus.shape[1]:
            self._proj = ip_projection(corpus, self.rank, self.train_sample,
                                       self.seed)
        corpus_r = np.ascontiguousarray(corpus @ self._proj)
        if mesh is None:
            self._corpus_r_dev = torch.from_numpy(corpus_r).to(self.device)
            self._proj_dev = torch.from_numpy(self._proj).to(self.device)
            return
        # the corpus' mesh padding rows project to zero rows
        padded = np.zeros((self._n_pad, corpus_r.shape[1]), np.float32)
        padded[:corpus_r.shape[0]] = corpus_r
        self._corpus_r_dev = shard_batch(mesh, padded)
        self._proj_dev = replicated(mesh, self._proj)

    def add(self, reps: np.ndarray, ids) -> None:
        super().add(reps, ids)
        # membership changed: retrain the basis and re-project at the next
        # search
        self._proj = None
        self._corpus_r_dev = None

    def _dispatch_chunk(self, chunk: np.ndarray, depth: int, mask=None):
        chunk = np.ascontiguousarray(chunk, np.float32)
        if self._mesh is not None:
            return sharded_ann_topk(
                self._mesh,
                [q.to(self.dtype) for q in replicated(self._mesh, chunk)],
                self._corpus_dev, self._corpus_r_dev, self._proj_dev,
                self._n_valid, depth, self.candidates, self.recall_target,
                mask)
        k = min(depth, self._n_valid)
        q = torch.from_numpy(chunk).to(self.device).to(self.dtype)
        c = max(min(self.candidates, self._n_valid), k)
        return ann_topk_packed(q, self._corpus_dev, self._corpus_r_dev,
                               self._proj_dev, k, c, self.recall_target,
                               mask)

    # Artifacts are plain DenseFlatIndex pickles (rows + lookup): the basis
    # is retrained deterministically at placement, so either class loads
    # the other's save.

    @classmethod
    def from_flat(cls, flat: DenseFlatIndex, **kwargs) -> "DenseANNIndex":
        """An ANN index over an exact index's rows (the host arrays are
        shared, not copied; the flat index's device state is untouched)."""
        out = cls(dim=flat.dim, dtype=flat.dtype, device=flat.device,
                  **kwargs)
        out._chunks = list(flat._chunks)
        out.lookup = list(flat.lookup)
        return out
