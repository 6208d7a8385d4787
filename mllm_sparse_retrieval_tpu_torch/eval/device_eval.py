"""Evaluation from device ranks: recall, MRR, nDCG and MAP without copying
the runs (the JAX package's ``eval/device_eval.py``, one device).

When the product of a search is its metrics, the run has no other
consumer: ``ops/eval_ranks.py`` computes each query's target ranks from
the packed top-k on the device, the host copies one ``[B, 1+T]`` int32
tensor per chunk, and ``metrics_from_ranks`` gives the numbers that
``eval.recall.recall_at_k`` and ``eval.metrics.ranking_metrics`` give on
the run the host route would have built from the same device output: the
same counts and the same per-query terms summed in the same row order.
Duplicate query ids collapse last-write-wins as run dicts do, but a dict
keeps the first insertion's position, so float sums may associate
differently there.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.eval.metrics import MetricResult
from mllm_sparse_retrieval_tpu_torch.eval.recall import RecallResult
from mllm_sparse_retrieval_tpu_torch.ops.eval_ranks import (
    NO_HIT, ranks_from_packed)
from mllm_sparse_retrieval_tpu_torch.ops.stream import pipeline_dispatch


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port evaluates on one device: meshes wait for sharding "
            "(ROADMAP Queue 1 #9)")


def build_target_arrays(qids: Sequence[str], get_target: Callable,
                        doc_pos: Dict[str, int], remove_query: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-query target and self arrays for the rank ops:
    ``(tgt [B, T] int32, n_targets [B] int32, self_pos [B] int32)``.

    ``tgt`` holds each target's position in the index's id order (-1 for
    padding and for targets absent from the corpus, which never hit, as an
    absent id never appears in a host run); ``n_targets`` is
    ``len(set(str(t)))``, the host consumers' ``|T|``, absent targets
    counted; ``self_pos`` is the query's own doc position (-1 when not
    removing or not a corpus doc), the ``remove_query`` rule of
    ``make_run``.
    """
    b = len(qids)
    per_q = []
    for q in qids:
        t = get_target(str(q))
        per_q.append({str(x) for x in t} if isinstance(t, (list, tuple, set))
                     else {str(t)})
    t_max = max((len(ts) for ts in per_q), default=1) or 1
    tgt = np.full((b, t_max), -1, np.int32)
    n_targets = np.zeros(b, np.int32)
    self_pos = np.full(b, -1, np.int32)
    for i, (q, ts) in enumerate(zip(qids, per_q)):
        n_targets[i] = len(ts)
        for j, t in enumerate(ts):
            tgt[i, j] = doc_pos.get(t, -1)
        if remove_query:
            self_pos[i] = doc_pos.get(str(q), -1)
    return tgt, n_targets, self_pos


def _pad_rows(a: np.ndarray, rows: int, fill) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    pad_shape = (rows - a.shape[0],) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, a.dtype)])


def _ranks_pipeline(chunks, dispatch_fn, lookahead: int = 3) -> np.ndarray:
    """Each chunk's ``[Bp, 1+T]`` ranks copy overlaps the next chunk's
    device work (``ops/stream.py``); the ranks of every chunk, cut to its
    real rows, concatenated."""
    out = []

    def resolve(handle):
        r_dev, take = handle
        out.append(r_dev.cpu().numpy()[:take])

    collections.deque(
        pipeline_dispatch(chunks, dispatch_fn, resolve, lookahead), maxlen=0)
    return np.concatenate(out) if out else np.zeros((0, 2), np.int32)


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def impact_eval_ranks(index, q_idx: np.ndarray, q_w: np.ndarray,
                      tgt: np.ndarray, self_pos: np.ndarray, depth: int,
                      mesh=None, backend: str = "auto",
                      lookahead: int = 3) -> np.ndarray:
    """Target ranks of an impact search (``[B, 1+T]`` int32), without
    copying the run: the index's own plan, chunks and scoring (the TAAT
    kernel on the card), then ``ranks_from_packed`` under the impact rule
    (scores <= 0 drop, as in ``ImpactIndex._resolve_encoded``)."""
    _no_mesh(mesh)
    plan = index._search_plan(backend, depth)

    def chunk_iter():
        pos = 0
        for chunk_i, chunk_w, take in index._chunk_queries(plan, q_idx, q_w):
            yield chunk_i, chunk_w, take, pos
            pos += take

    def dispatch(item):
        chunk_i, chunk_w, take, pos = item
        packed = index._dispatch_encoded(plan, chunk_i, chunk_w)
        bp = packed.shape[0]
        return ranks_from_packed(
            packed, _to(_pad_rows(tgt[pos:pos + take], bp, -1), index.device),
            _to(_pad_rows(self_pos[pos:pos + take], bp, -1), index.device),
            rule="positive"), take

    return _ranks_pipeline(chunk_iter(), dispatch, lookahead)


def dense_eval_ranks(index, q_reps: np.ndarray, tgt: np.ndarray,
                     self_pos: np.ndarray, depth: int, batch_size: int = 128,
                     mesh=None, lookahead: int = 3) -> np.ndarray:
    """Target ranks of a dense MIPS search (rule ``'all'``: the unfiltered
    host route keeps every returned entry). ``tgt`` and ``self_pos`` are
    dense-lookup positions."""
    _no_mesh(mesh)
    index._materialize()
    q_reps = np.asarray(q_reps, dtype=np.float32)
    n = q_reps.shape[0]

    def chunk_iter():
        for start in range(0, n, batch_size):
            chunk = q_reps[start:start + batch_size]
            valid = chunk.shape[0]
            if valid < batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((batch_size - valid, chunk.shape[1]),
                                     chunk.dtype)])
            yield chunk, valid, start

    def dispatch(item):
        chunk, take, pos = item
        packed = index._dispatch_chunk(chunk, depth)
        bp = packed.shape[0]
        return ranks_from_packed(
            packed, _to(_pad_rows(tgt[pos:pos + take], bp, -1), index.device),
            _to(_pad_rows(self_pos[pos:pos + take], bp, -1), index.device),
            rule="all"), take

    return _ranks_pipeline(chunk_iter(), dispatch, lookahead)


def metrics_from_ranks(qids: Sequence[str], ranks: np.ndarray,
                       n_targets: np.ndarray, ks: Sequence[int],
                       which: Sequence[str] = (),
                       denominator: Optional[int] = None
                       ) -> Tuple[RecallResult, Dict[str, MetricResult]]:
    """Recall@k and the ``which`` metrics (``mrr``, ``ndcg``, ``map``) from
    the ranks of the rank ops and each query's true ``|targets|``: the
    values ``recall_at_k`` + ``ranking_metrics`` give on the host run."""
    ks = sorted(set(int(k) for k in ks))
    qarr = [str(q) for q in qids]
    if len(qarr) != ranks.shape[0]:
        raise ValueError("qids/ranks length mismatch")
    # run dicts collapse duplicate qids last-write-wins
    if len(set(qarr)) != len(qarr):
        keep_row = {q: i for i, q in enumerate(qarr)}
        sel = sorted(keep_row.values())
        qarr = [qarr[i] for i in sel]
        ranks = ranks[sel]
        n_targets = n_targets[sel]

    n_row = ranks[:, 0]
    tranks = ranks[:, 1:]
    hits = {k: 0 for k in ks}
    sums = {m: {k: 0.0 for k in ks} for m in which}
    evaluated = int((n_row > 0).sum())
    first = tranks.min(axis=1) if tranks.shape[1] else \
        np.full(len(qarr), NO_HIT, np.int64)
    for k in ks:
        hits[k] = int(((first <= k) & (n_row > 0)).sum())
    if which:
        for i in range(len(qarr)):
            if n_row[i] <= 0:
                continue
            hit_ranks = np.sort(tranks[i][tranks[i] < NO_HIT])
            if hit_ranks.size == 0:
                continue
            f = int(hit_ranks[0])
            nt = int(n_targets[i])
            for k in ks:
                if "mrr" in sums and f <= k:
                    sums["mrr"][k] += 1.0 / f
                within = hit_ranks[hit_ranks <= k]
                if within.size == 0:
                    continue
                if "ndcg" in sums:
                    dcg = sum(1.0 / math.log2(int(r) + 1) for r in within)
                    ideal = sum(1.0 / math.log2(j + 1)
                                for j in range(1, min(k, nt) + 1))
                    sums["ndcg"][k] += dcg / ideal
                if "map" in sums:
                    ap = sum((j + 1) / int(r) for j, r in enumerate(within))
                    sums["map"][k] += ap / min(k, nt)
    denom = max(denominator if denominator is not None else len(qarr), 1)
    recall = RecallResult(recalls={k: hits[k] / denom for k in ks},
                          hits=hits, num_queries=evaluated)
    extras = {m: MetricResult(name=m,
                              values={k: sums[m][k] / denom for k in ks},
                              num_queries=evaluated)
              for m in which}
    return recall, extras


def impact_doc_pos(index) -> Dict[str, int]:
    """Doc id -> position in the impact index's id order, cached on the
    index and keyed on the id list object."""
    if getattr(index, "_doc_pos_src", None) is not index.doc_ids:
        index._doc_pos = {d: i for i, d in enumerate(index.doc_ids)}
        index._doc_pos_src = index.doc_ids
    return index._doc_pos


def dense_doc_pos(index) -> Dict[str, int]:
    """Doc id -> position in the dense index's lookup order, cached like
    ``impact_doc_pos``."""
    if getattr(index, "_lookup_pos_src", None) is not index.lookup:
        index._lookup_pos = {d: i for i, d in enumerate(index.lookup)}
        index._lookup_pos_src = index.lookup
    return index._lookup_pos
