"""PyTorch port: evaluation from device ranks (``ops/eval_ranks.py``,
``eval/device_eval.py``, ``FusedHybridSearcher.eval_ranks``) against the
JAX package's on the same numpy-seeded inputs, and against the host
consumers (``eval.recall.recall_at_k``, ``eval.metrics.ranking_metrics``)
on the port's own runs.

Tolerances: exact. ``ranks_from_packed`` and ``metrics_from_ranks`` on the
same inputs give equal arrays and equal floats (the same operations in the
same order). The ranks of a whole search equal the JAX package's except
for a target whose score ties with another returned doc's (``torch.topk``
and ``lax.top_k`` order equal scores differently), which the comparison
leaves out after counting that most targets are compared; the metrics
equal the host consumers' on the port's own run exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.eval import device_eval as jde
from mllm_sparse_retrieval_tpu.index.dense import (
    DenseFlatIndex as JDenseFlatIndex)
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.ops import eval_ranks as jer
from mllm_sparse_retrieval_tpu.search.device_fusion import (
    FusedHybridSearcher as JSearcher)
from mllm_sparse_retrieval_tpu_torch.eval import device_eval as de
from mllm_sparse_retrieval_tpu_torch.eval.metrics import ranking_metrics
from mllm_sparse_retrieval_tpu_torch.eval.recall import recall_at_k
from mllm_sparse_retrieval_tpu_torch.index import DenseFlatIndex, ImpactIndex
from mllm_sparse_retrieval_tpu_torch.ops import eval_ranks as er
from mllm_sparse_retrieval_tpu_torch.parallel import make_mesh
from mllm_sparse_retrieval_tpu_torch.search.device_fusion import (
    FusedHybridSearcher)
from mllm_sparse_retrieval_tpu_torch.search.runs import make_run

KS = (1, 3, 5, 10)
WHICH = ("mrr", "ndcg", "map")
N_DOCS, N_TERMS, DIM = 60, 50, 12


# ---- ranks_from_packed and metrics_from_ranks on the same inputs ------------

@pytest.mark.parametrize("rule", ["positive", "finite", "all"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ranks_from_packed_matches_jax(rule, seed):
    rng = np.random.default_rng(seed)
    b, k, t = 10, 16, 4
    scores = np.sort(rng.integers(-4, 20, size=(b, k)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    scores[2, -5:] = -np.inf
    scores[3] = -np.inf                                # nothing valid
    idx = np.stack([rng.permutation(40)[:k] for _ in range(b)]).astype(
        np.int32)
    tgt = np.stack([rng.choice(idx[i], size=t, replace=False)
                    for i in range(b)]).astype(np.int32)
    tgt[:, -1] = -1                                    # padding
    tgt[5, 0] = 99                                     # absent
    self_pos = np.full(b, -1, np.int32)
    self_pos[::2] = idx[::2, 1]                        # self removal
    packed = np.concatenate([scores.view(np.int32), idx], axis=1)
    got = er.ranks_from_packed(torch.from_numpy(packed),
                               torch.from_numpy(tgt),
                               torch.from_numpy(self_pos), rule=rule)
    want = jer.ranks_from_packed(jnp.asarray(packed), jnp.asarray(tgt),
                                 jnp.asarray(self_pos), rule=rule)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert er.NO_HIT == jer.NO_HIT
    with pytest.raises(ValueError, match="rule"):
        er.ranks_from_packed(torch.from_numpy(packed),
                             torch.from_numpy(tgt),
                             torch.from_numpy(self_pos), rule="some")


@pytest.mark.parametrize("denominator", [None, 30])
def test_metrics_from_ranks_matches_jax(denominator):
    rng = np.random.default_rng(4)
    b, t = 14, 3
    ranks = rng.integers(1, 15, size=(b, 1 + t)).astype(np.int32)
    ranks[:, 1:][rng.random((b, t)) < 0.4] = er.NO_HIT
    ranks[3, 0] = 0                                    # empty row
    ranks[3, 1:] = er.NO_HIT
    n_targets = rng.integers(1, 5, size=b).astype(np.int32)
    qids = [f"q{i}" for i in range(b)]
    qids[9] = "q2"                                     # duplicate qid
    got = de.metrics_from_ranks(qids, ranks, n_targets, KS, WHICH,
                                denominator)
    want = jde.metrics_from_ranks(qids, ranks, n_targets, KS, WHICH,
                                  denominator)
    assert (got[0].recalls, got[0].hits, got[0].num_queries) == \
        (want[0].recalls, want[0].hits, want[0].num_queries)
    assert {m: (r.values, r.num_queries) for m, r in got[1].items()} == \
        {m: (r.values, r.num_queries) for m, r in want[1].items()}
    with pytest.raises(ValueError, match="length"):
        de.metrics_from_ranks(qids[:-1], ranks, n_targets, KS)


# ---- whole searches ---------------------------------------------------------


def _world(seed):
    rng = np.random.default_rng(seed)
    doc_ids = [f"d{i}" for i in range(N_DOCS)]
    vecs = []
    for _ in doc_ids:
        terms = rng.choice(N_TERMS, size=rng.integers(3, 9), replace=False)
        vecs.append({f"t{t}": int(rng.integers(1, 400)) for t in terms})
    order = rng.permutation(N_DOCS)                    # shuffled dense order
    reps = rng.normal(size=(N_DOCS, DIM)).astype(np.float32)
    n_q = 12
    q_dicts = []
    for q in range(n_q):
        if q == 4:          # out of vocabulary: an empty row
            q_dicts.append({"zzz-oov": 5})
            continue
        terms = rng.choice(N_TERMS, size=5, replace=False)
        q_dicts.append({f"t{t}": int(rng.integers(1, 10)) for t in terms})
    q_reps = rng.normal(size=(n_q, DIM)).astype(np.float32)
    qids = [doc_ids[2 * q] for q in range(n_q)]        # self hits
    tmap = {}
    for q in qids:
        picks = [doc_ids[int(i)] for i in
                 rng.choice(N_DOCS, size=3, replace=False)]
        if int(q[1:]) % 3 == 0:
            picks.append(f"absent-{q}")                # not in the corpus
        tmap[q] = picks
    out = {}
    for pkg, imp_cls, dense_cls, kw in (
            ("p", ImpactIndex, DenseFlatIndex, dict(device="cpu")),
            ("j", JImpactIndex, JDenseFlatIndex, {})):
        impact = imp_cls(**kw)
        for d, v in zip(doc_ids, vecs):
            impact.add(d, v)
        impact.finalize()
        dense = dense_cls(**kw)
        dense.add(reps[order], [doc_ids[i] for i in order])
        out[pkg] = (impact, dense)
    return out, q_dicts, q_reps, qids, tmap.__getitem__


def _tied_targets(rows_s, rows_i, get_target, qids):
    """(query row, target) pairs whose score equals another returned
    doc's: their ranks depend on tie order."""
    tied = set()
    for r, (q, s_row, i_row) in enumerate(zip(qids, rows_s, rows_i)):
        s_row = list(s_row)
        for d, s in zip(i_row, s_row):
            if d in get_target(q) and s_row.count(s) > 1:
                tied.add((r, d))
    return tied


def _same_ranks(got, want, tgt, doc_of, tied):
    """Equal valid-entry counts; equal target ranks except where tied.
    Returns how many target ranks were compared."""
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    compared = 0
    for r in range(got.shape[0]):
        for j in range(tgt.shape[1]):
            if tgt[r, j] < 0 or (r, doc_of[tgt[r, j]]) in tied:
                continue
            assert got[r, 1 + j] == want[r, 1 + j], (r, j)
            compared += 1
    return compared


def _host_metrics(run, get_target):
    return recall_at_k(run, get_target, KS), ranking_metrics(
        run, get_target, KS, which=WHICH)


def _assert_metrics(dev, host):
    assert (dev[0].recalls, dev[0].hits, dev[0].num_queries) == \
        (host[0].recalls, host[0].hits, host[0].num_queries)
    for m in WHICH:
        assert dev[1][m].values == host[1][m].values, m


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("remove_query", [False, True])
def test_impact_eval_ranks_match_jax_and_host(remove_query, chunked):
    built, q_dicts, _, qids, get_target = _world(0)
    (imp, _), (jimp, _) = built["p"], built["j"]
    depth = 10
    q_idx, q_w = imp.encode_queries(q_dicts)
    tgt, ntg, selfp = de.build_target_arrays(
        qids, get_target, de.impact_doc_pos(imp), remove_query=remove_query)
    jt = jde.build_target_arrays(qids, get_target, jde.impact_doc_pos(jimp),
                                 remove_query=remove_query)
    for a, b in zip((tgt, ntg, selfp), jt):
        np.testing.assert_array_equal(a, b)
    budget = imp.hbm_budget_bytes
    try:
        if chunked:     # max_b floors at 8: 12 queries take two chunks
            imp._materialize("f32")
            imp.hbm_budget_bytes = sum(
                d.numel() * d.element_size() for d in imp._dev.values()) + 1
        ranks = de.impact_eval_ranks(imp, q_idx, q_w, tgt, selfp, depth)
        if chunked:
            assert imp._search_plan("auto", depth)["max_b"] < len(q_dicts)
    finally:
        imp.hbm_budget_bytes = budget
    jranks = np.asarray(jde.impact_eval_ranks(jimp, q_idx, q_w, tgt, selfp,
                                              depth))
    s, i = imp.search(q_dicts, depth)
    compared = _same_ranks(ranks, jranks, tgt, imp.doc_ids,
                           _tied_targets(s, i, get_target, qids))
    assert compared >= 10
    run = make_run(qids, s, i, remove_query=remove_query, scores_sorted=True)
    _assert_metrics(de.metrics_from_ranks(qids, ranks, ntg, KS, WHICH),
                    _host_metrics(run, get_target))


@pytest.mark.parametrize("remove_query", [False, True])
def test_dense_eval_ranks_match_jax_and_host(remove_query):
    built, _, q_reps, qids, get_target = _world(1)
    (_, dense), (_, jdense) = built["p"], built["j"]
    depth = 10
    tgt, ntg, selfp = de.build_target_arrays(
        qids, get_target, de.dense_doc_pos(dense), remove_query=remove_query)
    ranks = de.dense_eval_ranks(dense, q_reps, tgt, selfp, depth,
                                batch_size=5)
    jranks = np.asarray(jde.dense_eval_ranks(jdense, q_reps, tgt, selfp,
                                             depth, batch_size=5))
    s, i = dense.search_ids(q_reps, depth, batch_size=5)
    compared = _same_ranks(ranks, jranks, tgt, dense.lookup,
                           _tied_targets(s, i, get_target, qids))
    assert compared >= 10
    run = make_run(qids, s.tolist(), i, remove_query=remove_query,
                   scores_sorted=True)
    _assert_metrics(de.metrics_from_ranks(qids, ranks, ntg, KS, WHICH),
                    _host_metrics(run, get_target))
    # over a 2-shard mesh: the (scores, idx) mesh form, the same ranks
    mesh = make_mesh(2, devices=["cpu"] * 2)
    np.testing.assert_array_equal(
        de.dense_eval_ranks(dense, q_reps, tgt, selfp, depth, batch_size=5,
                            mesh=mesh), ranks)


@pytest.mark.parametrize("remove_query", [False, True])
def test_fused_eval_ranks_match_jax_and_host(remove_query):
    built, q_dicts, q_reps, qids, get_target = _world(5)
    (imp, dense), (jimp, jdense) = built["p"], built["j"]
    depth = 12
    q_idx, q_w = imp.encode_queries(q_dicts)
    searcher = FusedHybridSearcher(dense, imp, alpha=0.4)
    tgt, ntg, _ = de.build_target_arrays(qids, get_target,
                                         de.dense_doc_pos(dense))
    self_q = qids if remove_query else None
    ranks = searcher.eval_ranks(q_reps, q_idx, q_w, tgt, depth, qids=self_q)
    jranks = np.asarray(JSearcher(jdense, jimp, alpha=0.4).eval_ranks(
        q_reps, q_idx, q_w, tgt, depth, qids=self_q))
    s, i = searcher.search_encoded(q_reps, q_idx, q_w, depth, qids=self_q)
    # the fused union depends on each engine's tie choice at its depth
    # cut, so only rows whose sparse run has no tie at the cut compare
    s_rows = imp.search(q_dicts, depth)[0]
    cut_tie = {r for r, row in enumerate(s_rows)
               if len(row) == depth and row.count(row[-1]) > 1}
    keep = [r for r in range(len(qids)) if r not in cut_tie]
    compared = _same_ranks(ranks[keep], jranks[keep], tgt[keep],
                           dense.lookup,
                           _tied_targets([s[r] for r in keep],
                                         [i[r] for r in keep], get_target,
                                         [qids[r] for r in keep]))
    assert compared >= 8
    run = searcher.search_run(q_reps, q_idx, q_w, qids, depth,
                              remove_query=remove_query)
    _assert_metrics(de.metrics_from_ranks(qids, ranks, ntg, KS, WHICH),
                    _host_metrics(run, get_target))


def test_doc_pos_maps_are_cached_on_the_index():
    built, *_ = _world(2)
    imp, dense = built["p"]
    a = de.impact_doc_pos(imp)
    assert de.impact_doc_pos(imp) is a and a["d3"] == imp.doc_ids.index("d3")
    b = de.dense_doc_pos(dense)
    assert de.dense_doc_pos(dense) is b and \
        b["d3"] == dense.lookup.index("d3")
    assert de.metrics_from_ranks([], np.zeros((0, 2), np.int32),
                                 np.zeros(0, np.int32), KS)[0].recalls == \
        {k: 0.0 for k in KS}
