"""Hybrid retrieval by definition: a caption's sparse terms, exact impact
scores, float32 inner products, the weighted min-max fusion, and the
numbers that judge a served result list.

- terms: the caption's candidate ids with ``round(100 * w)`` of their
  ``log1p(relu)`` weights (half to even), those above 0 kept;
- impact score of a doc: the sum over its terms of query weight times doc
  weight, exact (float64 holds these integers);
- each engine's run: its top ``depth`` docs (the sparse run only docs that
  score above 0); each run min-max normalised, ``(s - min) / max(max -
  min, 1e-9)``; a doc's fused score ``alpha * dense + (1 - alpha) *
  sparse``, 0 from a run that lacks it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def query_terms(sparse_row: torch.Tensor, cand: np.ndarray,
                scale: float = 100.0) -> Dict[int, int]:
    vals = sparse_row[torch.as_tensor(cand, device=sparse_row.device)]
    w = np.rint(vals.double().cpu().numpy() * scale).astype(np.int64)
    return {int(i): int(x) for i, x in zip(cand, w) if x > 0}


class Corpus:
    """The corpus as the benchmark made it: per doc ``k`` term ids and
    integer weights (``[N, k]``), and f32 dense rows ``[N, D]``, on the
    device. Doc ``i`` has the id ``str(i)``."""

    def __init__(self, doc_terms: torch.Tensor, doc_weights: torch.Tensor,
                 rows: torch.Tensor):
        self.doc_terms = doc_terms.long()
        self.doc_weights = doc_weights.double()
        self.rows = rows.float()

    def impact(self, terms: Dict[int, int]) -> torch.Tensor:
        """``[N]`` float64 exact impact scores."""
        dev = self.doc_terms.device
        top = int(self.doc_terms.max()) + 1
        q = torch.zeros(max(top, max(terms, default=0) + 1),
                        dtype=torch.float64, device=dev)
        if terms:
            q[torch.tensor(list(terms), device=dev)] = torch.tensor(
                list(terms.values()), dtype=torch.float64, device=dev)
        return (q[self.doc_terms] * self.doc_weights).sum(1)

    def inner(self, dense: torch.Tensor) -> torch.Tensor:
        """``[N]`` float32 inner products with one query vector."""
        return self.rows @ dense.float()


def top_run(scores: torch.Tensor, depth: int, positive: bool
            ) -> Dict[int, float]:
    vals, idx = torch.topk(scores, min(depth, scores.numel()))
    run = {int(i): float(v) for v, i in zip(vals.tolist(), idx.tolist())}
    return {d: s for d, s in run.items() if s > 0} if positive else run


def _normalised(run: Dict[int, float]) -> Dict[int, float]:
    if not run:
        return {}
    lo, hi = min(run.values()), max(run.values())
    den = max(hi - lo, 1e-9)
    return {d: (s - lo) / den for d, s in run.items()}


def fuse(dense_run: Dict[int, float], sparse_run: Dict[int, float],
         alpha: float) -> Dict[int, float]:
    nd, ns = _normalised(dense_run), _normalised(sparse_run)
    return {d: alpha * nd.get(d, 0.0) + (1.0 - alpha) * ns.get(d, 0.0)
            for d in set(nd) | set(ns)}


def search(corpus: Corpus, terms: Dict[int, int], dense: torch.Tensor,
           depth: int, alpha: float) -> Dict[int, float]:
    """The fused scores of one query's candidates (doc index -> score)."""
    return fuse(top_run(corpus.inner(dense), depth, False),
                top_run(corpus.impact(terms), depth, True), alpha)


def judge(served: Sequence[Tuple[str, float]], fused: Dict[int, float],
          depth: int) -> Tuple[float, float]:
    """(regret, score gap) of one served list against the reference's
    fused scores: at each rank ``i < depth``, how far the reference's
    score of the served doc lies below the reference's ``i``-th best
    (a doc outside the reference's candidates scores 0; a missing entry
    counts as 0), and how far the served score lies from that best."""
    best: List[float] = sorted(fused.values(), reverse=True)[:depth]
    best += [0.0] * (depth - len(best))
    regret = gap = 0.0
    for i in range(depth):
        if i < len(served):
            doc, score = served[i]
            got = fused.get(int(doc), 0.0)
            gap = max(gap, abs(float(score) - best[i]))
        else:
            got = 0.0
            gap = max(gap, best[i])
        regret = max(regret, best[i] - got)
    return regret, gap
