"""Approximate MIPS on one device: a low-rank prefilter, then an exact
rescore (the JAX package's ``ops/ann.py``, single-device programs; that
package computes them outside any Pallas kernel too).

- Stage 1: queries and corpus are projected to ``rank`` dimensions with an
  inner-product-preserving basis (``ip_projection``: the top eigenvectors
  of the uncentered Gram matrix) and scored in full f32.
- Stage 2: ``torch.topk`` picks ``candidates`` rows per query. The JAX
  package calls ``lax.approx_max_k`` here, whose ``recall_target`` trades
  recall for speed on a TPU; the port's selection is exact (as
  ``approx_max_k`` is on the JAX CPU backend), and ``recall_target`` is
  accepted and has no effect.
- Stage 3: the candidate rows are gathered from the full-precision corpus
  and rescored in full f32 (TF32 off, the counterpart of
  ``precision=HIGHEST``), so a returned score equals the exact index's to
  f32 rounding and only the candidate set is approximate. Working set:
  ``B x candidates x d``.

Not ported: the sharded programs (ROADMAP Queue 1 #9).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.ops.packing import pack_topk
from mllm_sparse_retrieval_tpu_torch.ops.score_programs import (
    full_f32_matmul)


def ip_projection(reps: np.ndarray, rank: int, sample: int = 65536,
                  seed: int = 0) -> np.ndarray:
    """Top-``rank`` eigenbasis of the uncentered Gram matrix -> ``[d, rank]``
    f32 (numpy on the host). Uncentered on purpose: inner products, not
    distances, are preserved, and centering would shift every score by a
    query-dependent constant that can reorder MIPS results."""
    x = np.asarray(reps, np.float32)
    if x.shape[0] > sample:
        keep = np.random.default_rng(seed).choice(x.shape[0], sample,
                                                  replace=False)
        x = x[keep]
    rank = min(int(rank), x.shape[1])
    gram = (x.astype(np.float64).T @ x.astype(np.float64)) / max(x.shape[0], 1)
    _, vecs = np.linalg.eigh(gram)           # ascending eigenvalues
    return np.ascontiguousarray(vecs[:, ::-1][:, :rank]).astype(np.float32)


def _rescore_exact(q: torch.Tensor, corpus: torch.Tensor,
                   c_idx: torch.Tensor) -> torch.Tensor:
    """Gather the candidate rows and rescore them in full f32: ``[B, C]``
    scores equal to the exact index's for the same rows to f32 rounding."""
    cand = corpus[c_idx].float()                            # [B, C, d]
    with full_f32_matmul():
        return torch.bmm(cand, q.float()[:, :, None])[:, :, 0]


def ann_topk_packed(q: torch.Tensor, corpus: torch.Tensor,
                    corpus_r: torch.Tensor, proj: torch.Tensor, k: int,
                    candidates: int, recall_target: float = 0.95,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Approximate MIPS as one ``[B, 2k]`` int32 tensor
    (``ops.packing.unpack_topk`` inverts: the ``DenseFlatIndex`` contract).

    ``q [B, d]`` in the corpus dtype, ``corpus [N, d]`` full-precision rows,
    ``corpus_r [N, r]`` f32 projected rows, ``proj [d, r]`` f32. With
    ``mask`` (bool ``[N]``) the stage-1 scores of excluded rows are -inf,
    so the candidates come from allowed rows only, and any excluded
    candidate rescoring -inf stays out of the top-k. ``recall_target`` is
    the JAX package's knob; the port's selection is exact."""
    with full_f32_matmul():
        s1 = (q.float() @ proj) @ corpus_r.T
    if mask is not None:
        s1.masked_fill_(~mask[None, :], float("-inf"))
    c_idx = torch.topk(s1, candidates, dim=1).indices
    scores = _rescore_exact(q, corpus, c_idx)
    if mask is not None:
        scores = scores.masked_fill(~mask[c_idx], float("-inf"))
    vals, pos = torch.topk(scores, k, dim=1)
    return pack_topk(vals, torch.gather(c_idx, 1, pos))
