"""Ranked-retrieval metrics beyond recall: MRR@k, nDCG@k, MAP@k (a copy of
the JAX package's ``eval/metrics.py``).

Same run shapes and conventions as ``recall_at_k``: score-descending
ranking with stable ties, binary multi-target relevance, and a mean over
``len(run)`` queries unless ``denominator`` is given.

Definitions (binary relevance, cutoff k, targets T, ranks 1-based):

- ``MRR@k``   = mean of ``1 / rank(first relevant)`` if that rank <= k
  else 0.
- ``nDCG@k``  = DCG@k / IDCG@k with ``DCG = sum 1/log2(rank + 1)`` over
  relevant ranked docs; ``IDCG`` places ``min(k, |T|)`` relevants first.
- ``MAP@k``   = mean AP@k, ``AP = sum_{relevant hit at rank r <= k}
  precision@r / min(k, |T|)`` (the TREC convention).
"""

from __future__ import annotations

import heapq
import math
import operator
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Sequence, Union

DEFAULT_KS = (1, 5, 10, 100, 200)   # recall's cutoffs

_SCORE = operator.itemgetter(1)


@dataclass
class MetricResult:
    """Per-cutoff means for one metric."""
    name: str = ""
    values: Dict[int, float] = field(default_factory=dict)
    num_queries: int = 0

    def __getitem__(self, k: int) -> float:
        return self.values[k]

    def format(self, prefix: str = "") -> str:
        parts = ", ".join(f"{self.name}@{k} {self.values[k]:.4f}"
                          for k in sorted(self.values))
        return f"{prefix} {parts}" if prefix else parts


def _targets_of(get_target: Callable, qid: str) -> set:
    target = get_target(qid)
    if isinstance(target, (list, tuple, set)):
        return {str(t) for t in target}
    return {str(target)}


def _iter_ranked(run, get_target, max_k):
    """Yield ``(hit ranks (1-based, ascending, <= max_k), |targets|)`` per
    evaluated query: one stable partial sort per query, shared by every
    metric and cutoff. ArrayRun rows (search/runs.py) are already
    score-descending with the same tie order and are read as they are."""
    rows = getattr(run, "ranked_rows", None)
    rows = rows() if rows is not None else None
    if rows is not None:
        for qid, _s_row, i_row in rows:
            if len(i_row) == 0:
                continue
            targets = _targets_of(get_target, qid)
            yield [rank for rank, doc in enumerate(i_row[:max_k], 1)
                   if str(doc) in targets], len(targets)
        return
    for qid, entry in run.items():
        docs = entry["docs"] if isinstance(entry, dict) and "docs" in entry \
            else entry
        if len(docs) == 0:
            continue
        targets = _targets_of(get_target, qid)
        ordered = heapq.nlargest(max_k, docs.items(), key=_SCORE)
        hit_ranks = [rank for rank, (doc, _) in enumerate(ordered, 1)
                     if str(doc) in targets]
        yield hit_ranks, len(targets)


def _run_metrics(
    run, get_target, ks: Sequence[int], denominator: Optional[int],
    which: Sequence[str],
) -> Dict[str, MetricResult]:
    ks = sorted(set(int(k) for k in ks))
    max_k = ks[-1]
    sums = {m: {k: 0.0 for k in ks} for m in which}
    evaluated = 0
    for hit_ranks, n_targets in _iter_ranked(run, get_target, max_k):
        evaluated += 1
        if not hit_ranks:
            continue
        first = hit_ranks[0]
        for k in ks:
            if "mrr" in sums and first <= k:
                sums["mrr"][k] += 1.0 / first
            within = [r for r in hit_ranks if r <= k]
            if not within:
                continue
            if "ndcg" in sums:
                dcg = sum(1.0 / math.log2(r + 1) for r in within)
                ideal = sum(1.0 / math.log2(i + 1)
                            for i in range(1, min(k, n_targets) + 1))
                sums["ndcg"][k] += dcg / ideal
            if "map" in sums:
                ap = sum((i + 1) / r for i, r in enumerate(within))
                sums["map"][k] += ap / min(k, n_targets)
    denom = max(denominator if denominator is not None else len(run), 1)
    return {
        m: MetricResult(name=m,
                        values={k: sums[m][k] / denom for k in ks},
                        num_queries=evaluated)
        for m in which
    }


def mrr_at_k(run, get_target, ks: Sequence[int] = DEFAULT_KS,
             denominator: Optional[int] = None) -> MetricResult:
    return _run_metrics(run, get_target, ks, denominator, ("mrr",))["mrr"]


def ndcg_at_k(run, get_target, ks: Sequence[int] = DEFAULT_KS,
              denominator: Optional[int] = None) -> MetricResult:
    return _run_metrics(run, get_target, ks, denominator, ("ndcg",))["ndcg"]


def map_at_k(run, get_target, ks: Sequence[int] = DEFAULT_KS,
             denominator: Optional[int] = None) -> MetricResult:
    return _run_metrics(run, get_target, ks, denominator, ("map",))["map"]


def ranking_metrics(
    run: Mapping[str, Union[dict, Mapping[str, float]]],
    get_target,
    ks: Sequence[int] = DEFAULT_KS,
    denominator: Optional[int] = None,
    which: Sequence[str] = ("mrr", "ndcg", "map"),
) -> Dict[str, MetricResult]:
    """All requested metrics in ONE pass over the run (one partial sort
    per query regardless of how many metrics/cutoffs are requested)."""
    bad = set(which) - {"mrr", "ndcg", "map"}
    if bad:
        raise ValueError(f"unknown metrics: {sorted(bad)}")
    return _run_metrics(run, get_target, ks, denominator, tuple(which))
