"""Hybrid score fusion and TREC run IO on the host (the JAX package's
``search/fusion.py``, its pure-Python bodies).

- ``fuse``: per query, each run's scores are min-max normalized with the
  run's recorded per-query min/max (denominator floored at 1e-9), weighted
  and summed; a doc missing from a run contributes 0.
- ``fuse_rrf``: Reciprocal Rank Fusion.
- ``fuse_statistic``: ``fuse`` with each doc tagged 'dense' / 'sparse' /
  'fuse' by the runs it came from; ``explain_fusion``: one fused score's
  parts.
- TREC read/write. The reader sets ``min_score`` to the *last* line's score
  (file order), the true minimum of a ranked file, as the reference does.

``fuse`` hands dict input to the C helper (``hostops.fuse_runs``), which
gives the same doubles (the same operations in the same order) as the
Python body (``_fuse_python``), its semantic reference.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Dict, Sequence

from mllm_sparse_retrieval_tpu_torch import hostops as _hostops
from mllm_sparse_retrieval_tpu_torch.search.runs import Run

_SCORE = operator.itemgetter(1)


@dataclass
class ResultRecord:
    score: float
    type: str  # 'dense' | 'sparse' | 'fuse'


def read_trec_run(path: str) -> Run:
    run: Run = {}
    with open(path) as f:
        for line in f:
            qid, _, docid, _rank, score, _name = line.strip().split()
            s = float(score)
            if qid not in run:
                run[qid] = {"docs": {}, "max_score": s, "min_score": s}
            run[qid]["docs"][docid] = s
            run[qid]["min_score"] = s
    return run


def write_trec_run(run: Run, path: str, name: str = "fusion") -> None:
    rows = getattr(run, "ranked_rows", None)
    rows = rows() if rows is not None else None
    with open(path, "w") as f:
        if rows is not None:
            # ArrayRun rows are already score-descending, ties in the dict
            # path's stable sort order
            for qid, s_row, i_row in rows:
                for i, (doc, score) in enumerate(zip(i_row, s_row)):
                    f.write(f"{qid} Q0 {doc} {i + 1} {score} {name}\n")
            return
        for qid in run:
            doc_score = run[qid]
            if isinstance(doc_score, dict) and "docs" in doc_score:
                doc_score = doc_score["docs"]
            ordered = sorted(doc_score.items(), key=_SCORE, reverse=True)
            for i, (doc, score) in enumerate(ordered):
                f.write(f"{qid} Q0 {doc} {i + 1} {score} {name}\n")


def _normalized(run_entry: dict, doc: str) -> float:
    lo = run_entry["min_score"]
    hi = run_entry["max_score"]
    denom = max(hi - lo, 1e-9)
    return (run_entry["docs"][doc] - lo) / denom


def fuse(runs: Sequence[Run], weights: Sequence[float]) -> Dict[str, Dict[str, float]]:
    """Weighted min-max fusion. Returns ``qid -> {docid: fused_score}``.

    A qid missing from one run (an asymmetric pair: e.g. a sparse query
    with no terms, which query.tsv skips) contributes 0 from that run; the
    reference raises ``KeyError`` there.

    Dict input takes the C fusion; entries of a surprising shape make it
    raise ``TypeError`` and take the Python body.
    """
    runs = [r.materialize() if hasattr(r, "materialize") else r
            for r in runs]
    if len(weights) >= len(runs) and all(type(r) is dict for r in runs):
        try:
            return _hostops.get().fuse_runs(list(runs),
                                            [float(x) for x in weights])
        except TypeError:
            pass
    return _fuse_python(runs, weights)


def _fuse_python(runs: Sequence[Run], weights: Sequence[float]
                 ) -> Dict[str, Dict[str, float]]:
    """``fuse``'s Python body (dict runs), the C fusion's semantic
    reference."""
    fused: Dict[str, Dict[str, float]] = {}
    qids = set()
    for run in runs:
        qids.update(run.keys())
    empty = {"docs": {}}
    for qid in qids:
        fused[qid] = {}
        for run in runs:
            for doc in run.get(qid, empty)["docs"]:
                if doc in fused[qid]:
                    continue
                score = 0.0
                for temp_run, weight in zip(runs, weights):
                    entry = temp_run.get(qid)
                    if entry is not None and doc in entry["docs"]:
                        score += weight * _normalized(entry, doc)
                fused[qid][doc] = score
    return fused


def fuse_rrf(runs: Sequence[Run], weights: Sequence[float] = None,
             k: int = 60) -> Dict[str, Dict[str, float]]:
    """Reciprocal Rank Fusion (Cormack et al. 2009) — the other standard
    hybrid rule beside the reference's min-max sum: per query,
    ``score(doc) = sum_i w_i / (k + rank_i(doc))`` with 1-based ranks by
    descending score (stable — ties keep insertion order, the repo rule);
    a doc missing from a run contributes 0 there. Unlike min-max, RRF is
    scale-free (no min/max bookkeeping); ``k=60`` is the paper's
    default."""
    if weights is None:
        weights = [1.0] * len(runs)
    runs = [r.materialize() if hasattr(r, "materialize") else r
            for r in runs]
    fused: Dict[str, Dict[str, float]] = {}
    qids = set()
    for run in runs:
        qids.update(run.keys())
    for qid in qids:
        out: Dict[str, float] = {}
        for run, weight in zip(runs, weights):
            entry = run.get(qid)
            if entry is None:
                continue
            docs = entry["docs"] if isinstance(entry, dict) and \
                "docs" in entry else entry
            ordered = sorted(docs.items(), key=_SCORE, reverse=True)
            for rank, (doc, _) in enumerate(ordered, 1):
                out[doc] = out.get(doc, 0.0) + weight / (k + rank)
        fused[qid] = out
    return fused


def explain_fusion(runs: Sequence[Run], weights: Sequence[float],
                   qid: str, docid: str) -> Dict:
    """Breakdown of one fused (query, doc) score: per-run raw score,
    per-query min/max normalization bounds, normalized value, weight, and
    weighted part — the arithmetic of ``fuse`` made inspectable
    (``sum(parts) == fuse(...)[qid][docid]``, asserted in tests). A run
    missing the doc (or the qid) contributes 0 — the asymmetric-run rule.
    """
    parts = []
    total = 0.0
    for i, (run, weight) in enumerate(zip(runs, weights)):
        entry = run.get(qid)
        part = {"run": i, "weight": float(weight), "raw_score": None,
                "min_score": None, "max_score": None, "normalized": 0.0,
                "contribution": 0.0}
        if entry is not None and docid in entry["docs"]:
            norm = _normalized(entry, docid)
            part.update(raw_score=float(entry["docs"][docid]),
                        min_score=float(entry["min_score"]),
                        max_score=float(entry["max_score"]),
                        normalized=norm,
                        contribution=float(weight) * norm)
            total += part["contribution"]
        parts.append(part)
    return {"qid": qid, "doc_id": docid, "score": total, "runs": parts}


def fuse_statistic(
    runs: Sequence[Run], weights: Sequence[float]
) -> Dict[str, Dict[str, ResultRecord]]:
    """Fusion with provenance tags, for the score-statistics diagnostics.

    A doc found in only the first run is 'dense', only a later run
    'sparse', in several runs 'fuse'.
    """
    runs = [r.materialize() if hasattr(r, "materialize") else r
            for r in runs]
    fused: Dict[str, Dict[str, ResultRecord]] = {}
    qids = set()
    for run in runs:
        qids.update(run.keys())
    empty = {"docs": {}}
    for qid in qids:
        fused[qid] = {}
        for run_count, run in enumerate(runs, start=1):
            for doc in run.get(qid, empty)["docs"]:
                if doc in fused[qid]:
                    continue
                score = 0.0
                score_count = 0
                for temp_run, weight in zip(runs, weights):
                    entry = temp_run.get(qid)
                    if entry is not None and doc in entry["docs"]:
                        score += weight * _normalized(entry, doc)
                        score_count += 1
                if score_count == 1:
                    score_type = "dense" if run_count == 1 else "sparse"
                else:
                    score_type = "fuse"
                fused[qid][doc] = ResultRecord(score, score_type)
    return fused
