"""Recall@k over run dictionaries (a copy of the JAX package's
``eval/recall.py``).

Per query, docs rank by score descending (ties keep insertion order: the
sort is stable), the top-k doc ids are taken, and the query is a hit if
*any* of its ground-truth ids is among them (an image query has ~5 relevant
captions, a text query one image). The denominator defaults to the number
of distinct queries in the run; ``denominator`` overrides it (the
reference counts issued queries, padding duplicates included).
"""

from __future__ import annotations

import heapq
import operator
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Union

DEFAULT_KS = (1, 5, 10, 100, 200)  # the reference's cutoffs

_SCORE = operator.itemgetter(1)


@dataclass
class RecallResult:
    recalls: Dict[int, float] = field(default_factory=dict)
    hits: Dict[int, int] = field(default_factory=dict)
    num_queries: int = 0

    def __getitem__(self, k: int) -> float:
        return self.recalls[k]

    def format(self, name: str = "") -> str:
        parts = ", ".join(f"r@{k} {self.recalls[k]:.4f}" for k in sorted(self.recalls))
        return f"{name} recall: {parts}" if name else f"recall: {parts}"


def recall_at_k(
    run: Mapping[str, Union[dict, Mapping[str, float]]],
    get_target,
    ks: Sequence[int] = DEFAULT_KS,
    denominator: Optional[int] = None,
) -> RecallResult:
    """Compute recall@k for a run.

    Args:
      run: ``qid -> {'docs': {docid: score}, ...}`` or ``qid -> {docid: score}``
        (the fused-run shape).
      get_target: callable ``qid -> docid | [docid, ...]`` (ground truth).
      ks: cutoffs.
      denominator: override the recall denominator (see module docstring).
    """
    ks = sorted(set(int(k) for k in ks))
    hits = {k: 0 for k in ks}
    evaluated = 0
    max_k = max(ks)
    rows = getattr(run, "ranked_rows", None)
    rows = rows() if rows is not None else None
    if rows is not None:
        # ArrayRun rows (search/runs.py) are already score-descending with
        # the dict path's tie order: the top-k prefix is a slice
        for qid, _s_row, i_row in rows:
            if len(i_row) == 0:
                continue
            evaluated += 1
            target = get_target(qid)
            targets = {str(t) for t in target} \
                if isinstance(target, (list, tuple, set)) else {str(target)}
            found_rank = None
            for rank, doc in enumerate(i_row[:max_k]):
                if str(doc) in targets:
                    found_rank = rank
                    break
            for k in ks:
                if found_rank is not None and found_rank < k:
                    hits[k] += 1
        denom = denominator if denominator is not None else len(run)
        denom = max(denom, 1)
        return RecallResult(
            recalls={k: hits[k] / denom for k in ks},
            hits=hits, num_queries=evaluated)
    for qid, entry in run.items():
        docs = entry["docs"] if isinstance(entry, dict) and "docs" in entry else entry
        if len(docs) == 0:
            continue
        evaluated += 1
        target = get_target(qid)
        targets = {str(t) for t in target} if isinstance(target, (list, tuple, set)) \
            else {str(target)}
        # nlargest equals sorted(..., reverse=True)[:n], tie order
        # included, without sorting the tail no cutoff reads
        ordered = heapq.nlargest(max_k, docs.items(), key=_SCORE)
        top_ids = [doc for doc, _ in ordered]
        found_rank = None
        for rank, doc in enumerate(top_ids):
            if str(doc) in targets:
                found_rank = rank
                break
        for k in ks:
            if found_rank is not None and found_rank < k:
                hits[k] += 1

    denom = denominator if denominator is not None else len(run)
    denom = max(denom, 1)
    return RecallResult(
        recalls={k: hits[k] / denom for k in ks},
        hits=hits,
        num_queries=evaluated,
    )
