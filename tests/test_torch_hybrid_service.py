"""PyTorch port: the service's dense and hybrid modes
(``RetrievalService(dense_index=..., impact_index=...)``: device-fused
min-max hybrid, host-fused hybrid for filtered requests and for RRF, and
dense mode) against the JAX package's ``RetrievalService`` on the same
indexes, built from the tiny_debug model's encodings of seeded captions,
and against the host ``search.fusion`` of the port's own engine runs.

Tolerances: scores within ``1e-5`` abs (the JAX package's device-fusion
tolerance; dense scores are f32 products of the same vectors, fused
scores f32 on the device against float64 on the host), compared as (doc,
score) sets up to docs tied at the depth cut. RRF scores depend on the
rank each doc of a tie block gets, so the RRF service is held to
``fuse_rrf`` of the port's own runs exactly, and to the JAX service only
for queries whose two candidate rows hold no tie.
"""

import jax
import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.index.dense import (
    DenseFlatIndex as JDenseFlatIndex)
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.serving import (
    OnlineQueryEncoder as JEncoder, RetrievalService as JService)
from mllm_sparse_retrieval_tpu.sparse import (
    canonical_id_map as j_canonical_id_map)
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, SparseConfig)
from mllm_sparse_retrieval_tpu_torch.index import (
    DenseFlatIndex, DocFilter, ImpactIndex)
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse, fuse_rrf
from mllm_sparse_retrieval_tpu_torch.serving import (
    OnlineQueryEncoder, RetrievalService)
from mllm_sparse_retrieval_tpu_torch.sparse import (
    SelectedTerms, canonical_id_map)

TINY = dict(tiny_vocab_size=512, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4)
N_CORPUS, N_QUERY, DEPTH, CAND, ALPHA = 48, 12, 10, 20, 0.4
TOL = 1e-5


def _captions(seed, n):
    rng = np.random.default_rng(seed)
    nouns = [f"{c}{v}{e}" for c in "bcdfgklmnprst" for v in "aeiou"
             for e in ("n", "t", "")]
    verbs = ["runs", "sits", "jumps", "walks", "plays", "holds", "looks"]
    out = []
    for _ in range(n):
        words = list(rng.choice(nouns, size=int(rng.integers(4, 9))))
        words.insert(1, str(rng.choice(verbs)))
        out.append("A " + " ".join(words) + " near the " +
                   str(rng.choice(nouns)) + ".")
    return out


@pytest.fixture(scope="module")
def world():
    """The tiny model in both packages; the corpus (the JAX encoder's terms
    and dense vectors of every caption) in a JAX and a port impact index
    and dense index (dense rows in another doc order); query terms and
    dense vectors from the JAX encoder; two doc filters."""
    caps = _captions(0, N_CORPUS)
    jparams, jarch, jtok, jtmpl = j_build_model(
        JModelConfig(family=JFamily.TINY_DEBUG, dtype="float32", **TINY),
        captions=caps, seed=0)
    tok = WordPieceLiteTokenizer.from_corpus_captions(
        caps, vocab_size=TINY["tiny_vocab_size"])
    spec = get_family_spec(ModelFamily.TINY_DEBUG,
                           ModelConfig(dtype="float32", **TINY))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    jenc = JEncoder(jparams, jarch, jtok, jtmpl, JSparseConfig(),
                    max_text_len=64)
    enc = OnlineQueryEncoder(params, spec.arch, tok, spec.template,
                             SparseConfig(), max_text_len=64, device="cpu")
    jterms, jdense = [], []
    for i in range(0, N_CORPUS, 16):
        d, t = jenc.encode_texts(caps[i:i + 16], pad_to=16)
        jterms += t
        jdense.append(np.asarray(d))
    jdense = np.concatenate(jdense)
    doc_ids = [f"c{i}" for i in range(N_CORPUS)]
    order = np.random.default_rng(1).permutation(N_CORPUS)
    jindex = JImpactIndex.from_selected_terms(
        doc_ids, jterms, j_canonical_id_map(jtok.get_vocab(), True))
    index = ImpactIndex.from_selected_terms(
        doc_ids, [SelectedTerms(t.token_ids, t.weights) for t in jterms],
        canonical_id_map(tok.get_vocab(), True), device="cpu")
    jd, pd = JDenseFlatIndex(), DenseFlatIndex(device="cpu")
    for d in (jd, pd):
        d.add(jdense[order], [doc_ids[i] for i in order])
    queries = caps[:N_QUERY // 2] + _captions(1, N_QUERY // 2)
    q_dense, q_terms = jenc.encode_texts(queries, pad_to=16)
    q_dense = np.asarray(q_dense)
    jsvc = JService(impact_index=jindex, query_encoder=jenc,
                    depth_levels=(DEPTH,), max_batch=2)
    try:
        terms = [jsvc._terms_dict(t) for t in q_terms]
    finally:
        jsvc.close()
    filters = {"thirds": doc_ids[::3], "few": doc_ids[:4]}
    return dict(jenc=jenc, enc=enc, j=(jd, jindex), p=(pd, index),
                queries=queries, q_dense=q_dense, terms=terms,
                filters=filters)


def _same_up_to_ties(got, want, depth=DEPTH, tol=TOL):
    """Rank-wise scores within ``tol``; every doc above the cut (``tol``
    of tie room) in both rows, its scores within ``tol``."""
    assert len(got) == len(want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=tol)
    w = dict(want)
    cut = got[-1][1] + 2 * tol if len(got) >= depth else -np.inf
    for doc, s in got:
        if s > cut:
            assert doc in w and abs(w[doc] - s) <= tol, (doc, s)


def _serve(cls, dense, impact, requests, **kw):
    svc = cls(dense, impact, depth_levels=(DEPTH, CAND), max_batch=4,
              max_wait_ms=20.0, **kw)
    try:
        futs = [svc.search_async(depth=DEPTH, **r) for r in requests]
        return [f.result(120) for f in futs], svc.mode
    finally:
        svc.close()


def _both(world, requests, dense=True, sparse=True, **kw):
    """The same requests through the port's and the JAX package's
    services over the same indexes."""
    pd, pi = world["p"]
    jd, ji = world["j"]
    got, mode = _serve(RetrievalService, pd if dense else None,
                       pi if sparse else None, requests, **kw)
    want, jmode = _serve(JService, jd if dense else None,
                         ji if sparse else None, requests, **kw)
    assert mode == jmode
    return got, want


def _host_rows(world, rows_d, rows_s, rule="minmax"):
    """``fuse`` / ``fuse_rrf`` of candidate rows, cut to DEPTH."""
    runs = []
    for rows in (rows_d, rows_s):
        run = {}
        for q, row in enumerate(rows):
            if row:
                run[str(q)] = {"docs": dict(row), "max_score": row[0][1],
                               "min_score": row[-1][1]}
        runs.append(run)
    fused = (fuse_rrf if rule == "rrf" else fuse)(runs, [ALPHA, 1 - ALPHA])
    return [sorted(fused.get(str(q), {}).items(), key=lambda kv: -kv[1])
            [:DEPTH] for q in range(len(rows_d))]


def _legs(world, dense_q, terms, flt=None):
    """Each of the port's engines' own rows at the candidate depth."""
    pd, pi = world["p"]
    df = sf = None
    if flt is not None:
        df = DocFilter.from_ids(pd.lookup, world["filters"][flt])
        sf = DocFilter.from_ids(pi.doc_ids, world["filters"][flt])
    d_s, d_i = pd.search_ids(np.stack(dense_q), CAND, doc_filter=df)
    s_s, s_i = pi.search_encoded(*pi.encode_queries(terms), CAND,
                                 backend="taat", doc_filter=sf)
    d_s = np.asarray(d_s).tolist() if flt is None else d_s
    return ([list(zip(i, map(float, s))) for s, i in zip(d_s, d_i)],
            [list(zip(i, map(float, s))) for s, i in zip(s_s, s_i)])


def test_dense_mode_matches_jax(world):
    reqs = [dict(dense=d) for d in world["q_dense"]]
    got, want = _both(world, reqs, sparse=False)
    pd = world["p"][0]
    ref_s, ref_i = pd.search_ids(world["q_dense"], DEPTH)
    for g, w, s, i in zip(got, want, ref_s, ref_i):
        _same_up_to_ties(g, w)
        _same_up_to_ties(g, list(zip(i, s.tolist())))


def test_device_fused_hybrid_terms_and_dense_matches_jax(world):
    reqs = [dict(terms=t, dense=d)
            for t, d in zip(world["terms"], world["q_dense"])]
    got, want = _both(world, reqs, alpha=ALPHA, candidate_depth=CAND)
    rows_d, rows_s = _legs(world, list(world["q_dense"]), world["terms"])
    host = _host_rows(world, rows_d, rows_s)
    both = 0
    for g, w, h, rd, rs in zip(got, want, host, rows_d, rows_s):
        _same_up_to_ties(g, w)
        _same_up_to_ties(g, h)
        both += bool({d for d, _ in g} & {d for d, _ in rd}
                     & {d for d, _ in rs})
    assert both > 0     # some served doc was found by both engines


def test_device_fused_hybrid_text_matches_host_fuse_and_jax(world):
    """``text=`` requests: the port's encoder's terms and dense vector
    (both kept for a hybrid index) through the device fusion, equal to the
    host fuse of the port's own engines on the same encodings; and against
    the JAX service with its own encoder, each engine taking every doc (no
    engine cut), within ``4e-5 * alpha / (hi - lo) + 1e-5`` of the query's
    dense candidate row (the encoders' dense vectors agree to 1e-5, and a
    min-max score moves with its score, the row's min and its max)."""
    queries = world["queries"]
    got, mode = _serve(RetrievalService, *world["p"],
                       [dict(text=q) for q in queries],
                       query_encoder=world["enc"], alpha=ALPHA,
                       candidate_depth=CAND)
    assert mode == "hybrid"
    dense_q, terms_rows = world["enc"].encode_texts(queries, pad_to=4 * (
        -(-len(queries) // 4)))
    svc = RetrievalService(*world["p"], query_encoder=world["enc"])
    try:
        terms = [svc._terms_dict(t) for t in terms_rows]
    finally:
        svc.close()
    rows_d, rows_s = _legs(world, list(dense_q), terms)
    for g, h in zip(got, _host_rows(world, rows_d, rows_s)):
        _same_up_to_ties(g, h)
    # a corpus caption finds itself first
    assert got[0][0][0] == "c0"
    reqs = [dict(text=q) for q in queries]
    got, _ = _serve(RetrievalService, *world["p"], reqs,
                    query_encoder=world["enc"], alpha=ALPHA,
                    candidate_depth=N_CORPUS)
    want, _ = _serve(JService, *world["j"], reqs,
                     query_encoder=world["jenc"], alpha=ALPHA,
                     candidate_depth=N_CORPUS)
    full_s, _ = world["p"][0].search_ids(dense_q[:len(queries)], N_CORPUS)
    for g, w, row in zip(got, want, full_s):
        span = max(float(row[0] - row[-1]), 1e-9)
        _same_up_to_ties(g, w, tol=4e-5 * ALPHA / span + TOL)


def test_filtered_hybrid_matches_jax_and_host_fuse(world):
    names = ["thirds", None, "few", "thirds"]
    reqs = [dict(terms=t, dense=d, filter=names[i % 4])
            for i, (t, d) in enumerate(zip(world["terms"],
                                           world["q_dense"]))]
    got, want = _both(world, reqs, alpha=ALPHA, candidate_depth=CAND,
                      filters=world["filters"])
    for i, (g, w) in enumerate(zip(got, want)):
        name = names[i % 4]
        _same_up_to_ties(g, w)
        if name is not None:
            assert {d for d, _ in g} <= set(world["filters"][name])
            rows_d, rows_s = _legs(world, [reqs[i]["dense"]],
                                   [reqs[i]["terms"]], name)
            _same_up_to_ties(g, _host_rows(world, rows_d, rows_s)[0])
    assert len(got[2]) <= 4                       # the 4-doc filter


def test_rrf_hybrid_matches_fuse_rrf(world):
    reqs = [dict(terms=t, dense=d)
            for t, d in zip(world["terms"], world["q_dense"])]
    got, want = _both(world, reqs, alpha=ALPHA, candidate_depth=CAND,
                      fusion_rule="rrf")
    rows_d, rows_s = _legs(world, list(world["q_dense"]), world["terms"])
    host = _host_rows(world, rows_d, rows_s, rule="rrf")
    untied = 0
    for g, w, h, rd, rs in zip(got, want, host, rows_d, rows_s):
        assert sorted(g, key=lambda p: (-p[1], p[0])) == \
            sorted(h, key=lambda p: (-p[1], p[0]))
        if all(len({s for _, s in r}) == len(r) for r in (rd, rs)):
            _same_up_to_ties(g, w, tol=1e-12)
            untied += 1
    assert untied >= 3


def test_service_validation(world):
    pd, pi = world["p"]
    with pytest.raises(ValueError, match="at least one"):
        RetrievalService()
    with pytest.raises(ValueError, match="fusion_rule"):
        RetrievalService(pd, pi, fusion_rule="max")
    with pytest.raises(ValueError, match="device_batch"):
        RetrievalService(pd, pi, max_batch=8, device_batch=4)
    svc = RetrievalService(pd, pi, depth_levels=(DEPTH,), max_batch=2,
                           filters={"few": world["filters"]["few"]})
    try:
        assert svc.mode == "hybrid" and svc.filter_names == ["few"]
        assert svc.register_filter("more", ["c1", "c2", "ghost"]) == 2
        assert svc.filter_names == ["few", "more"]
        d = world["q_dense"][0]
        t = world["terms"][0]
        with pytest.raises(ValueError, match="requires terms"):
            svc.search(dense=d)
        with pytest.raises(ValueError, match="requires dense"):
            svc.search(terms=t)
        with pytest.raises(ValueError, match="dense dim"):
            svc.search(terms=t, dense=d[:5])
        with pytest.raises(ValueError, match="unknown filter"):
            svc.search(terms=t, dense=d, filter="ghost")
        with pytest.raises(ValueError, match="query_encoder"):
            svc.search(text="a dog")
        rows = svc.search(terms=t, dense=d, filter="more")
        assert {doc for doc, _ in rows} <= {"c1", "c2"}
    finally:
        svc.close()
    svc = RetrievalService(pd, pi, query_encoder=world["enc"],
                           depth_levels=(DEPTH,), max_batch=2)
    try:
        with pytest.raises(ValueError, match="not both"):
            svc.search(text="a dog", dense=world["q_dense"][0])
    finally:
        svc.close()
    dense_only = RetrievalService(dense_index=pd, depth_levels=(DEPTH,),
                                  max_batch=2)
    try:
        assert dense_only.mode == "dense"
        with pytest.raises(ValueError, match="requires dense"):
            dense_only.search(terms=world["terms"][0])
    finally:
        dense_only.close()
