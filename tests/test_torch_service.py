"""PyTorch port, the slice end to end: ``RetrievalService.search(text=...)``
through the tiny_debug text tower, device term selection and the impact
index, against the JAX package's service on the same tokenizer, weights and
index. Captions come from a seed.

Tolerances: results compare as sets of ``(doc_id, round(score, 4))`` (the
JAX package's own serving test rule); selected terms must be identical and
dense reps agree to f32 ``atol=rtol=1e-5`` (XLA and PyTorch sum the tower's
matmuls in different orders).
"""

import threading

import jax
import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.serving import (
    OnlineQueryEncoder as JEncoder, RetrievalService as JService)
from mllm_sparse_retrieval_tpu.sparse import (
    canonical_id_map as j_canonical_id_map)
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, SparseConfig)
from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.serving import (
    OnlineQueryEncoder, RetrievalService)
from mllm_sparse_retrieval_tpu_torch.sparse import (
    SelectedTerms, canonical_id_map)

TINY = dict(tiny_vocab_size=512, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4)
N_CORPUS, N_QUERY, DEPTH = 48, 12, 10


def _captions(seed, n):
    rng = np.random.default_rng(seed)
    nouns = [f"{c}{v}{e}" for c in "bcdfgklmnprst" for v in "aeiou"
             for e in ("n", "t", "")]
    verbs = ["runs", "sits", "jumps", "walks", "plays", "holds", "looks"]
    out = []
    for _ in range(n):
        k = int(rng.integers(4, 9))
        words = list(rng.choice(nouns, size=k, p=None))
        words.insert(1, str(rng.choice(verbs)))
        out.append("A " + " ".join(words) + " near the " +
                   str(rng.choice(nouns)) + ".")
    return out


@pytest.fixture(scope="module")
def slice_setup():
    caps = _captions(0, N_CORPUS)
    jparams, jarch, jtok, jtmpl = j_build_model(
        JModelConfig(family=JFamily.TINY_DEBUG, dtype="float32", **TINY),
        captions=caps, seed=0)
    tok = WordPieceLiteTokenizer.from_corpus_captions(
        caps, vocab_size=TINY["tiny_vocab_size"])
    assert tok.get_vocab() == jtok.get_vocab()
    spec = get_family_spec(ModelFamily.TINY_DEBUG,
                           ModelConfig(dtype="float32", **TINY))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    jenc = JEncoder(jparams, jarch, jtok, jtmpl, JSparseConfig(),
                    max_text_len=64)
    enc = OnlineQueryEncoder(params, spec.arch, tok, spec.template,
                             SparseConfig(), max_text_len=64, device="cpu")
    # the corpus: the JAX encoder's terms for every caption
    jterms = []
    for i in range(0, N_CORPUS, 16):
        jterms += jenc.encode_texts(caps[i:i + 16], pad_to=16)[1]
    doc_ids = [f"c{i}" for i in range(N_CORPUS)]
    jcmap = j_canonical_id_map(jtok.get_vocab(), True)
    jindex = JImpactIndex.from_selected_terms(doc_ids, jterms, jcmap)
    index = ImpactIndex.from_selected_terms(
        doc_ids, [SelectedTerms(t.token_ids, t.weights) for t in jterms],
        canonical_id_map(tok.get_vocab(), True), device="cpu")
    queries = caps[:N_QUERY // 2] + _captions(1, N_QUERY // 2)
    return jenc, enc, jindex, index, queries


@pytest.mark.parametrize("cfg", [dict(), dict(num_expanded_tokens=5),
                                 dict(sparse_manual=True, sparse_length=16)])
def test_encoder_matches_jax(slice_setup, cfg):
    jenc, enc, _, _, queries = slice_setup
    if cfg:
        jenc = JEncoder(jenc.params, jenc.arch, jenc.tokenizer,
                        jenc.template, JSparseConfig(**cfg), max_text_len=64)
        enc = OnlineQueryEncoder(enc.params, enc.arch, enc.tokenizer,
                                 enc.template, SparseConfig(**cfg),
                                 max_text_len=64, device="cpu")
    dense, terms = enc.encode_texts(queries, pad_to=16)
    jdense, jterms = jenc.encode_texts(queries, pad_to=16)
    np.testing.assert_allclose(dense, jdense, atol=1e-5, rtol=1e-5)
    assert len(terms) == len(queries)
    for got, ref in zip(terms, jterms):
        np.testing.assert_array_equal(got.token_ids, ref.token_ids)
        np.testing.assert_array_equal(got.weights, ref.weights)


def _assert_same_up_to_ties(got, want):
    """Equal as sets of ``(doc_id, round(score, 4))``, except that docs tied
    at the depth cut may differ (which of several equal scores fills the
    last slots is tie order, not part of the contract): the score lists
    must be equal and every pair above the cut identical."""
    g = {(d, round(float(s), 4)) for d, s in got}
    w = {(d, round(float(s), 4)) for d, s in want}
    assert sorted(s for _, s in g) == sorted(s for _, s in w)
    if len(got) < DEPTH:
        assert g == w
        return
    cut = min(s for _, s in g)
    assert {p for p in g if p[1] > cut} == {p for p in w if p[1] > cut}


def _serve(service_cls, index, enc, queries, **kw):
    svc = service_cls(impact_index=index, query_encoder=enc,
                      depth_levels=(DEPTH,), max_batch=8, max_wait_ms=20.0,
                      **kw)
    try:
        futs = [svc.search_async(text=q) for q in queries]
        return [f.result(120) for f in futs]
    finally:
        svc.close()


@pytest.mark.parametrize("backend", ["taat", "matmul"])
def test_text_search_matches_jax_service(slice_setup, backend):
    jenc, enc, jindex, index, queries = slice_setup
    want = _serve(JService, jindex, jenc, queries)
    got = _serve(RetrievalService, index, enc, queries, backend=backend)
    hits = 0
    for g, w in zip(got, want):
        _assert_same_up_to_ties(g, w)
        assert [s for _, s in g] == sorted((s for _, s in g), reverse=True)
        hits += len(g)
    assert hits > 0
    # a corpus caption retrieves itself first
    assert got[0][0][0] == "c0"


def test_terms_queries_and_depth_cut(slice_setup):
    _, enc, _, index, _ = slice_setup
    svc = RetrievalService(impact_index=index, query_encoder=enc,
                           depth_levels=(5, 20), max_batch=4,
                           max_wait_ms=1.0)
    try:
        key = next(iter(index.term_to_idx))
        rows = svc.search(terms={key: 3.0, -1: 2.0}, depth=3)
        assert 0 < len(rows) <= 3
        assert svc.search(terms=[(key, 0.0)], depth=3) == []
    finally:
        svc.close()


def test_validation_and_close(slice_setup):
    _, enc, _, index, _ = slice_setup
    svc = RetrievalService(impact_index=index, depth_levels=(10,),
                           max_batch=2, max_wait_ms=1.0)
    thread = svc._batcher._thread
    assert thread.daemon
    try:
        with pytest.raises(ValueError, match="query_encoder"):
            svc.search(text="hello")
        with pytest.raises(ValueError, match="depth"):
            svc.search(terms={1: 1.0}, depth=11)
        with pytest.raises(ValueError, match="terms"):
            svc.search()
    finally:
        svc.close()
    thread.join(5)
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.search(terms={1: 1.0})
    svc = RetrievalService(impact_index=index, query_encoder=enc,
                           depth_levels=(10,), max_batch=2,
                           max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="not both"):
            svc.search(text="hello", terms={1: 1.0})
        with pytest.raises(ValueError, match="non-empty"):
            svc.search(text="   ")
    finally:
        svc.close()
    assert threading.active_count() >= 1
