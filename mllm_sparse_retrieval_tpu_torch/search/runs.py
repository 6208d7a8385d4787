"""Run dictionaries: per-query ranked results with min/max score
bookkeeping (the JAX package's ``search/runs.py``).

A "run" maps ``qid -> {'docs': {docid: score}, 'min_score': m,
'max_score': M}``, the structure the reference threads between search,
fusion and metrics. ``make_run`` hands all-list input to the C helper
(``hostops.build_runs``), which gives the same dicts as the Python body
(``_make_run_python``), its semantic reference.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterable, Sequence

import numpy as np

from mllm_sparse_retrieval_tpu_torch import hostops as _hostops

Run = Dict[str, dict]


class ArrayRun(Mapping):
    """Lazy run: batched (qid, scores row, ids row) triples held as-is,
    with the dict form materialized (via ``make_run``, same semantics to
    the bit) only on first dict-style access.

    When the consumer is recall, metrics or a TREC write, rows are
    consumed directly through ``iter_ranked()`` (already score-descending:
    no per-query dict build, no re-sort). Semantics are the dict's:

    - duplicate qids collapse last-write-wins, iterating at the FIRST
      occurrence's position (dict overwrite order);
    - ``remove_query`` drops the self doc from rows and from the dict, but
      min/max stay pre-removal (the reference's rule);
    - ``len``/truthiness/containment never materialize.
    """

    __slots__ = ("_qids", "_scores", "_ids", "_remove_query",
                 "_scores_sorted", "_order", "_dict")

    def __init__(self, batch_ids, batch_scores, batch_rankings,
                 remove_query: bool = False, scores_sorted: bool = False):
        self._qids = [str(q) for q in batch_ids]
        self._scores = batch_scores
        self._ids = batch_rankings
        self._remove_query = bool(remove_query)
        self._scores_sorted = bool(scores_sorted)
        order: Dict[str, int] = {}
        for row, q in enumerate(self._qids):     # dict-overwrite order
            order[q] = row
        self._order = order
        self._dict: Run = None

    # -- array fast path ------------------------------------------------------
    def ranked_rows(self):
        """``iter_ranked()`` when the fast path is safe: rows carry the
        score-descending promise AND no dict has been materialized (a
        caller holding the dict could have mutated it — the dict is then
        the source of truth). Returns ``None`` otherwise; consumers fall
        back to the Mapping path."""
        if self._dict is not None or not self._scores_sorted:
            return None
        return self.iter_ranked()

    def iter_ranked(self):
        """Yield ``(qid, scores_row, ids_row)`` in dict iteration order,
        duplicates collapsed, self hit removed under ``remove_query`` —
        rows are score-descending exactly as the dict consumers would
        rank them (stable-tie partial sort == insertion order)."""
        for q, row in self._order.items():
            s_row, i_row = self._scores[row], self._ids[row]
            if self._remove_query:
                # make_run str-maps non-str ids before popping the self
                # hit — match that here or int id rows would never drop it
                if not (i_row and type(i_row[0]) is str):
                    i_row = [str(d) for d in i_row]
            if self._remove_query and q in i_row:
                keep = [j for j, d in enumerate(i_row) if str(d) != q]
                s_row = [s_row[j] for j in keep]
                i_row = [i_row[j] for j in keep]
            yield q, s_row, i_row

    # -- Mapping protocol -----------------------------------------------------
    def materialize(self) -> Run:
        if self._dict is None:
            self._dict = make_run(self._qids, self._scores, self._ids,
                                  remove_query=self._remove_query,
                                  scores_sorted=self._scores_sorted)
        return self._dict

    def __getitem__(self, qid):
        return self.materialize()[qid]

    def __iter__(self):
        return iter(self._order)

    def __len__(self):
        return len(self._order)

    def __contains__(self, qid):
        return qid in self._order

    def __bool__(self):
        return bool(self._order)

    def __eq__(self, other):
        if isinstance(other, ArrayRun):
            other = other.materialize()
        if isinstance(other, Mapping):
            return self.materialize() == dict(other)
        return NotImplemented

    __hash__ = None        # mutable-mapping semantics, like dict


def make_run(
    batch_ids: Sequence[str],
    batch_scores: Sequence[Sequence[float]],
    batch_rankings: Sequence[Sequence[str]],
    remove_query: bool = False,
    scores_sorted: bool = False,
) -> Run:
    """Assemble a run dict from batched search output.

    Min/max are computed over *all* returned scores, before the optional
    self-hit removal (the reference's ``get_run_dict`` convention).
    ``scores_sorted=True`` promises each row is descending (what every
    search here returns), so min/max are the row's ends.

    All-list input (what the resolve paths produce) takes the C assembler;
    other input, or input it refuses (non-list rows, length mismatches),
    takes the Python body, which zip-truncates mismatched lengths.
    """
    if (type(batch_ids) is list and type(batch_scores) is list
            and type(batch_rankings) is list):
        try:
            return _hostops.get().build_runs(
                batch_ids, batch_scores, batch_rankings, bool(remove_query),
                bool(scores_sorted))
        except (TypeError, ValueError):
            pass
    return _make_run_python(batch_ids, batch_scores, batch_rankings,
                            remove_query, scores_sorted)


def _make_run_python(batch_ids, batch_scores, batch_rankings,
                     remove_query: bool = False,
                     scores_sorted: bool = False) -> Run:
    """``make_run``'s Python body, the C assembler's semantic reference."""
    run: Run = {}
    for qid, scores, rankings in zip(batch_ids, batch_scores, batch_rankings):
        if isinstance(rankings, np.ndarray):   # raw batch_search output
            rankings = rankings.tolist()
        if isinstance(scores, np.ndarray):
            scores = scores.tolist()
        keys = rankings if (not rankings or type(rankings[0]) is str) \
            else map(str, rankings)
        vals = scores if (not scores or type(scores[0]) is float) \
            else map(float, scores)
        docs = dict(zip(keys, vals))
        if remove_query:
            # removal AFTER min/max would change them; reference computes
            # min/max over all returned scores BEFORE removal — keep that
            docs.pop(str(qid), None)
        entry = {"docs": docs}
        if len(scores) == 0:
            entry["min_score"] = 0.0
            entry["max_score"] = 0.0
        elif scores_sorted:
            entry["min_score"] = float(scores[-1])
            entry["max_score"] = float(scores[0])
        else:
            entry["min_score"] = float(min(scores))
            entry["max_score"] = float(max(scores))
        run[str(qid)] = entry
    return run


def merge_runs(runs: Iterable[Run]) -> Run:
    """Union per-shard runs (each query appears in exactly one shard)."""
    out: Run = {}
    for r in runs:
        out.update(r)
    return out
