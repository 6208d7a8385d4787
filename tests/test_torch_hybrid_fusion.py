"""PyTorch port: hybrid fusion on the device (``ops/hybrid_fusion.py``,
``search/device_fusion.py``) against the JAX package's on the same
numpy-seeded inputs, and against the host ``search.fusion.fuse``.

Tolerances: fused scores within ``1e-5`` abs (the JAX package's own
device-fusion tolerance; both sides do the same f32 arithmetic, the host
fuse float64), compared as (doc, score) sets up to docs tied at the cut
(``torch.topk`` and ``lax.top_k`` order equal scores differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.index.dense import (
    DenseFlatIndex as JDenseFlatIndex)
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.ops import hybrid_fusion as jhf
from mllm_sparse_retrieval_tpu.ops.packing import unpack_topk as j_unpack
from mllm_sparse_retrieval_tpu.search.device_fusion import (
    FusedHybridSearcher as JSearcher)
from mllm_sparse_retrieval_tpu_torch.index import DenseFlatIndex, ImpactIndex
from mllm_sparse_retrieval_tpu_torch.ops import hybrid_fusion as hf
from mllm_sparse_retrieval_tpu_torch.ops.packing import unpack_topk
from mllm_sparse_retrieval_tpu_torch.parallel import make_mesh
from mllm_sparse_retrieval_tpu_torch.search.device_fusion import (
    FusedHybridSearcher)
from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse
from mllm_sparse_retrieval_tpu_torch.search.runs import make_run

TOL = 1e-5
ALPHA = 0.3


def _rows(scores, ids):
    """Finite (id, score) pairs of each row, score-descending."""
    out = []
    for s_row, i_row in zip(scores, ids):
        keep = np.isfinite(s_row)
        out.append(sorted(zip(np.asarray(i_row)[keep].tolist(),
                              np.asarray(s_row, np.float64)[keep].tolist()),
                          key=lambda p: -p[1]))
    return out


def _same_up_to_ties(got, want, cut_full=False):
    """Rank-wise scores within TOL; every doc above the last kept score
    (TOL of tie room) in both rows with scores within TOL. A row cut by
    its depth may hold different docs of the score at the cut."""
    assert len(got) == len(want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=TOL)
    w = dict(want)
    cut = -np.inf if cut_full or not got else got[-1][1] + 2 * TOL
    for doc, s in got:
        if s > cut:
            assert doc in w and abs(w[doc] - s) <= TOL, (doc, s)


# ---- fused_topk_packed on packed inputs ------------------------------------

B, KS, KD, N_IMPACT, N_DENSE = 9, 12, 10, 40, 36


def _packed_inputs(seed):
    """Packed sparse and dense top-k rows built to hold: docs in both runs,
    ties, non-positive and -inf sparse scores, impact columns past the
    index and impact docs absent from the dense index (perm -1), self
    indices, an all-equal row and rows whose union is shorter than the
    output."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N_DENSE + 4)[:N_IMPACT].astype(np.int32)
    perm[perm >= N_DENSE] = -1                     # absent from dense
    ss = np.sort(rng.integers(-3, 12, size=(B, KS)).astype(np.float32),
                 axis=1)[:, ::-1].copy()           # ties, zeros, negatives
    si = np.stack([rng.permutation(N_IMPACT)[:KS]
                   for _ in range(B)]).astype(np.int32)
    ds = np.sort(np.round(rng.normal(size=(B, KD)), 1).astype(np.float32),
                 axis=1)[:, ::-1].copy()           # ties
    di = np.stack([rng.permutation(N_DENSE)[:KD]
                   for _ in range(B)]).astype(np.int32)
    # docs in both runs: a few dense ids are the dense image of sparse ids
    for b in range(B):
        mapped = [perm[i] for i in si[b] if i < N_IMPACT and perm[i] >= 0]
        for j, d in enumerate(mapped[:4]):
            if d not in di[b]:
                di[b, 2 * j] = d
    ss[1, -3:] = -np.inf                           # filtered-out entries
    si[1, -3:] = N_IMPACT + np.arange(3)           # padding columns
    ss[2] = 5.0
    ds[2] = 0.25                                   # all-equal row
    ss[3, 2:] = 0.0
    ss[4] = 0.0                                    # empty sparse run
    ds[5, :] = ds[5, 0]
    self_idx = np.full(B, -1, np.int32)
    self_idx[0] = di[0, 0]                         # self in the dense run
    in_s = [perm[i] for s, i in zip(ss[6], si[6]) if s > 0 and perm[i] >= 0]
    self_idx[6] = in_s[0]                          # self in the sparse run
    self_idx[7] = N_DENSE + 50                     # not a corpus doc
    return ss, si, ds, di, perm, self_idx


def _pack(scores, idx):
    return np.concatenate([scores.view(np.int32), idx], axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("out_k", [KS + KD, 30, 7])
@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_fused_topk_packed_matches_jax(seed, out_k, alpha):
    ss, si, ds, di, perm, self_idx = _packed_inputs(seed)
    sp, dp = _pack(ss, si), _pack(ds, di)
    w_d, w_s = np.float32(alpha), np.float32(1.0 - alpha)
    want = np.asarray(jhf.fused_topk_packed(
        jnp.asarray(sp), jnp.asarray(dp), jnp.asarray(perm),
        jnp.asarray(self_idx), w_d, w_s, out_k))
    got = hf.fused_topk_packed(
        torch.from_numpy(sp), torch.from_numpy(dp), torch.from_numpy(perm),
        torch.from_numpy(self_idx), torch.tensor(w_d), torch.tensor(w_s),
        out_k).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == \
        (B, 2 * min(out_k, KS + KD))
    g_rows, w_rows = _rows(*unpack_topk(got)), _rows(*j_unpack(want))
    shortfall = 0
    for b, (g, w) in enumerate(zip(g_rows, w_rows)):
        _same_up_to_ties(g, w)
        assert self_idx[b] not in {d for d, _ in g}
        shortfall += len(g) < min(out_k, KS + KD)
    if out_k >= KS + KD:
        # the -inf fill of rows whose union is shorter than the output
        assert shortfall > 0
        # every union doc comes out: the row equals the float64 host rule
        for b, g in enumerate(g_rows):
            assert {str(d): sc for d, sc in g} == pytest.approx(
                _host_fused_row(ss[b], si[b], ds[b], di[b], perm,
                                self_idx[b], alpha), abs=TOL)


def _host_fused_row(ss, si, ds, di, perm, self_doc, alpha):
    """``search.fusion.fuse`` of one row's two runs, built as the engines'
    resolves build them (sparse: score > 0 and a dense image)."""
    keep = [(int(perm[i]), float(s)) for s, i in zip(ss, si)
            if s > 0 and i < N_IMPACT and perm[i] >= 0]
    runs = [make_run(["q"], [ds.astype(np.float64).tolist()],
                     [di.tolist()], remove_query=False),
            make_run(["q"], [[s for _, s in keep]], [[d for d, _ in keep]],
                     remove_query=False)]
    for run in runs:     # remove_query with a query id that is the doc
        run.get("q", {}).get("docs", {}).pop(str(self_doc), None)
    fused = fuse(runs, [alpha, 1.0 - alpha])
    return fused.get("q", {})


def test_all_equal_row_uses_the_floor_denominator():
    ss, si, ds, di, perm, self_idx = _packed_inputs(0)
    out = hf.fused_topk_packed(
        torch.from_numpy(_pack(ss, si)), torch.from_numpy(_pack(ds, di)),
        torch.from_numpy(perm), torch.from_numpy(self_idx),
        torch.tensor(np.float32(0.5)), torch.tensor(np.float32(0.5)),
        KS + KD).numpy()
    scores, _ = unpack_topk(out)
    # row 2: both runs all-equal, so (s - lo) / 1e-9 = 0 everywhere
    assert (scores[2][np.isfinite(scores[2])] == 0.0).all()


# ---- FusedHybridSearcher ----------------------------------------------------


def _build(seed, n_docs=80, dim=12, n_terms=60, bf16=False):
    """The same corpus in both packages: an impact index of string terms
    and a dense index in a shuffled doc order; 12 queries, one with no
    in-vocabulary term, one matching few docs; qids in the doc namespace
    (self hits)."""
    rng = np.random.default_rng(seed)
    doc_ids = [f"d{i}" for i in range(n_docs)]
    vecs = []
    for _ in doc_ids:
        terms = rng.choice(n_terms, size=rng.integers(3, 9), replace=False)
        vecs.append({f"t{t}": int(rng.integers(1, 40)) for t in terms})
    order = rng.permutation(n_docs)
    reps = rng.normal(size=(n_docs, dim)).astype(np.float32)
    n_q = 12
    q_reps = rng.normal(size=(n_q, dim)).astype(np.float32)
    q_dicts = []
    for q in range(n_q):
        if q == 8:
            q_dicts.append({"zzz-out-of-vocab": 5})
            continue
        terms = rng.choice(n_terms, size=(1 if q == 9 else 5), replace=False)
        q_dicts.append({f"t{t}": int(rng.integers(1, 10)) for t in terms})
    qids = [f"d{3 * q}" for q in range(n_q)]
    out = {}
    for pkg, imp_cls, dense_cls, kw, dkw in (
            ("p", ImpactIndex, DenseFlatIndex, dict(device="cpu"),
             dict(device="cpu", dtype=torch.bfloat16 if bf16
                  else torch.float32)),
            ("j", JImpactIndex, JDenseFlatIndex, {},
             dict(dtype=jnp.bfloat16 if bf16 else jnp.float32))):
        impact = imp_cls(**kw)
        for d, v in zip(doc_ids, vecs):
            impact.add(d, v)
        impact.finalize()
        dense = dense_cls(**dkw)
        dense.add(reps[order], [doc_ids[i] for i in order])
        out[pkg] = (impact, dense)
    return out, q_reps, q_dicts, qids


def _host_fused(impact, dense, q_reps, q_dicts, qids, depth, remove_query):
    d_scores, d_ids = dense.search_ids(q_reps, depth)
    dense_run = make_run(qids, d_scores.tolist(), d_ids,
                         remove_query=remove_query, scores_sorted=True)
    s_scores, s_ids = impact.search(q_dicts, depth)
    sparse_run = make_run(qids, s_scores, s_ids, remove_query=remove_query,
                          scores_sorted=True)
    return fuse([dense_run, sparse_run], [ALPHA, 1.0 - ALPHA])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("remove_query", [False, True])
def test_searcher_matches_jax_and_host_fuse(remove_query, bf16):
    """At depth 25 each engine cuts its run, and docs tied at a cut may
    differ between the packages, so the device route is held to the host
    fuse of the port's own runs there (the same top-k choices); at depth 80
    (every doc) it is held to the JAX package's searcher as well."""
    built, q_reps, q_dicts, qids = _build(0, bf16=bf16)
    (impact, dense), (jimpact, jdense) = built["p"], built["j"]
    searcher = FusedHybridSearcher(dense, impact, alpha=ALPHA)
    jsearcher = JSearcher(jdense, jimpact, alpha=ALPHA)
    q_idx, q_w = impact.encode_queries(q_dicts)
    jq_idx, jq_w = jimpact.encode_queries(q_dicts)
    np.testing.assert_array_equal(q_idx, jq_idx)
    for depth in (25, 80):
        # out_depth = the whole union: the doc sets must match exactly
        run = searcher.search_run(q_reps, q_idx, q_w, qids, depth,
                                  remove_query=remove_query,
                                  out_depth=2 * depth)
        host = _host_fused(impact, dense, q_reps, q_dicts, qids, depth,
                           remove_query)
        assert set(run) == set(host)
        for q in run:
            assert set(run[q]) == set(host[q]), q
            for doc, s in host[q].items():
                assert run[q][doc] == pytest.approx(s, abs=TOL), (q, doc)
            if remove_query:
                assert q not in run[q]
    jrun = jsearcher.search_run(q_reps, jq_idx, jq_w, qids, depth,
                                remove_query=remove_query,
                                out_depth=2 * depth)
    assert set(run) == set(jrun)
    for q in run:
        assert set(run[q]) == set(jrun[q]), q
        for doc, s in jrun[q].items():
            assert run[q][doc] == pytest.approx(s, abs=TOL), (q, doc)
    # docs fused from both runs
    s_rows = impact.search(q_dicts, 25)[1]
    d_rows = dense.search_ids(q_reps, 25)[1]
    assert sum(len(set(a) & set(b)) for a, b in zip(s_rows, d_rows)) > 0


@pytest.mark.parametrize("out_depth", [7, 25])
def test_search_encoded_matches_jax_up_to_ties(out_depth):
    built, q_reps, q_dicts, qids = _build(3)
    (impact, dense), (jimpact, jdense) = built["p"], built["j"]
    q_idx, q_w = impact.encode_queries(q_dicts)
    # each engine keeps every doc (depth 80), so the fused cut is the only
    # one where the packages' tie orders can differ
    s, i = FusedHybridSearcher(dense, impact, alpha=ALPHA).search_encoded(
        q_reps, q_idx, q_w, 80, out_depth=out_depth)
    js, ji = JSearcher(jdense, jimpact, alpha=ALPHA).search_encoded(
        q_reps, q_idx, q_w, 80, out_depth=out_depth)
    for a, b, c, d in zip(s, i, js, ji):
        assert a == sorted(a, reverse=True) and len(a) <= out_depth
        _same_up_to_ties(list(zip(b, a)), list(zip(d, c)))


def test_chunked_matches_single_and_stream_matches_batches():
    built, q_reps, q_dicts, qids = _build(7)
    impact, dense = built["p"]
    depth = 20
    q_idx, q_w = impact.encode_queries(q_dicts)
    searcher = FusedHybridSearcher(dense, impact, alpha=ALPHA)
    ref_s, ref_i = searcher.search_encoded(q_reps, q_idx, q_w, depth)
    # a budget for one matrix and 8 score rows forces chunks of 8 with a
    # zero-padded tail
    saved = impact.hbm_budget_bytes
    impact.hbm_budget_bytes = sum(
        d.numel() * d.element_size() for d in impact._dev.values()) \
        + 8 * 2048 * 4 * 3
    try:
        plan = impact._search_plan("matmul", depth)
        assert plan["max_b"] < len(q_dicts)
        got_s, got_i = searcher.search_encoded(q_reps, q_idx, q_w, depth)
        cuts = [(0, 5), (5, 7), (7, 12)]
        batches = [(q_reps[a:b], q_idx[a:b], q_w[a:b], qids[a:b])
                   for a, b in cuts]
        serial = [searcher.search_encoded(q_reps[a:b], q_idx[a:b],
                                          q_w[a:b], depth, qids=qids[a:b])
                  for a, b in cuts]
        streamed = list(searcher.search_encoded_stream(batches, depth,
                                                       lookahead=2))
    finally:
        impact.hbm_budget_bytes = saved
    assert streamed == serial
    for a, b, c, d in zip(ref_s, ref_i, got_s, got_i):
        np.testing.assert_allclose(a, c, atol=1e-6)
        assert set(b) == set(d)
    # the stream against the JAX package's, every doc in each engine's run
    jimpact, jdense = built["j"]
    jstream = list(JSearcher(jdense, jimpact, alpha=ALPHA)
                   .search_encoded_stream(batches, 80))
    pstream = list(searcher.search_encoded_stream(batches, 80))
    assert len(pstream) == len(jstream) == len(cuts)
    for (ps, pi), (js, ji) in zip(pstream, jstream):
        for a, b, c, d in zip(ps, pi, js, ji):
            _same_up_to_ties(list(zip(b, a)), list(zip(d, c)), cut_full=True)


def test_searcher_refuses_two_corpora_a_mutation_and_a_mesh():
    built, q_reps, q_dicts, _ = _build(1)
    impact, dense = built["p"]
    other = DenseFlatIndex(device="cpu")
    other.add(np.zeros((3, dense.dim), np.float32), ["d0", "d1", "x"])
    with pytest.raises(ValueError, match="one corpus"):
        FusedHybridSearcher(other, impact)
    searcher = FusedHybridSearcher(dense, impact)
    q_idx, q_w = impact.encode_queries(q_dicts)
    single = searcher.search_encoded(q_reps, q_idx, q_w, 5)
    # a mesh is no longer refused: over 2 shards, the same fused rows
    meshed = FusedHybridSearcher(
        dense, impact, mesh=make_mesh(2, devices=["cpu"] * 2))
    for a, b, c, d in zip(*single, *meshed.search_encoded(q_reps, q_idx,
                                                          q_w, 5)):
        _same_up_to_ties(list(zip(b, a)), list(zip(d, c)))
    dense.add(np.zeros((1, dense.dim), np.float32), ["extra"])
    with pytest.raises(RuntimeError, match="membership changed"):
        searcher.search_encoded(q_reps, q_idx, q_w, 5)
    with pytest.raises(RuntimeError, match="membership changed"):
        searcher.eval_ranks(q_reps, q_idx, q_w,
                            np.zeros((len(q_dicts), 1), np.int32), 5)
