"""PyTorch port, image queries end to end: ``OnlineQueryEncoder.encode_images``
and ``RetrievalService.search(image=...)`` against the JAX package's encoder
and service on the same tokenizer, weights, index and seeded images, for a
tiny LLaVA-NeXT anyres config and the tiny fixed-grid family.

Tolerances: dense reps agree to f32 ``atol=rtol=1e-5`` (XLA and PyTorch sum
the model's matmuls in different orders); selected terms are equal up to
ties, as sets of ``(token id, quantized weight)`` over the positive weights;
results compare as sets of ``(doc_id, round(score, 4))`` where docs tied at
the depth cut may differ (tie order is not part of the contract).
"""

import jax
import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models import templates as jtemplates
from mllm_sparse_retrieval_tpu.models.llama import LlamaConfig as JLlamaConfig
from mllm_sparse_retrieval_tpu.models.mllm import MLLMConfig as JMLLMConfig
from mllm_sparse_retrieval_tpu.models.tokenizer import (
    WordPieceLiteTokenizer as JTokenizer)
from mllm_sparse_retrieval_tpu.models.vit import ViTConfig as JViTConfig
from mllm_sparse_retrieval_tpu.serving import (
    OnlineQueryEncoder as JEncoder, RetrievalService as JService)
from mllm_sparse_retrieval_tpu.sparse import (
    canonical_id_map as j_canonical_id_map)
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, SparseConfig)
from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.models import templates
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig
from mllm_sparse_retrieval_tpu_torch.serving import (
    OnlineQueryEncoder, RetrievalService)
from mllm_sparse_retrieval_tpu_torch.sparse import (
    SelectedTerms, canonical_id_map)

DEPTH = 10
VIT = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
           num_heads=4, feature_layer=-2)
TEXT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, rope_theta=10000.0)
PINPOINTS = ((28, 56), (56, 28), (56, 56))
TINY = dict(tiny_vocab_size=256, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4)
CAPTIONS = ["a dog runs on grass", "a cat sits on a mat",
            "two people ride bikes", "a red bus in the city",
            "a man holds a kite", "three birds on a wire",
            "a boat on the lake", "children play in the snow"]
SIZES = [(64, 64), (40, 120), (120, 40), (30, 30), (90, 60), (61, 200)]


def _images(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=s + (3,)).astype(np.float32) for s in sizes]


def _build(kind):
    """JAX encoder, port encoder, JAX index, port index, for ``kind``."""
    if kind == "anyres":
        jtok = JTokenizer.from_corpus_captions(CAPTIONS, vocab_size=96)
        jarch = JMLLMConfig(vision=JViTConfig(**VIT),
                            text=JLlamaConfig(**TEXT), image_token_id=4,
                            grid_pinpoints=PINPOINTS)
        arch = MLLMConfig(vision=ViTConfig(**VIT), text=LlamaConfig(**TEXT),
                          image_token_id=4, grid_pinpoints=PINPOINTS)
        jparams = jmllm.init_params(jax.random.PRNGKey(0), jarch)
        jtmpl, tmpl = jtemplates.TINY, templates.TINY
        vocab = 96
    else:
        jparams, jarch, jtok, jtmpl = j_build_model(
            JModelConfig(family=JFamily.TINY_DEBUG, dtype="float32", **TINY),
            captions=CAPTIONS, seed=0)
        spec = get_family_spec(ModelFamily.TINY_DEBUG,
                               ModelConfig(dtype="float32", **TINY))
        arch, tmpl = spec.arch, spec.template
        vocab = TINY["tiny_vocab_size"]
    tok = WordPieceLiteTokenizer.from_corpus_captions(CAPTIONS,
                                                      vocab_size=vocab)
    assert tok.get_vocab() == jtok.get_vocab()
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    jenc = JEncoder(jparams, jarch, jtok, jtmpl, JSparseConfig())
    enc = OnlineQueryEncoder(params, arch, tok, tmpl, SparseConfig(),
                             device="cpu")
    # the corpus: the JAX encoder's terms for captions and for images
    jterms = jenc.encode_texts(CAPTIONS, pad_to=8)[1]
    jterms += jenc.encode_images(_images(9, SIZES[:4]), pad_to=4)[1]
    doc_ids = [f"d{i}" for i in range(len(jterms))]
    jindex = JImpactIndex.from_selected_terms(
        doc_ids, jterms, j_canonical_id_map(jtok.get_vocab(), True))
    index = ImpactIndex.from_selected_terms(
        doc_ids, [SelectedTerms(t.token_ids, t.weights) for t in jterms],
        canonical_id_map(tok.get_vocab(), True), device="cpu")
    return jenc, enc, jindex, index


@pytest.fixture(scope="module", params=["anyres", "fixed"])
def image_setup(request):
    return _build(request.param)


def _assert_same_terms(got, ref):
    g = {(int(i), int(w)) for i, w in zip(got.token_ids, got.weights)
         if w > 0}
    r = {(int(i), int(w)) for i, w in zip(ref.token_ids, ref.weights)
         if w > 0}
    assert g == r and g


@pytest.mark.parametrize("cfg", [dict(), dict(num_expanded_tokens=5),
                                 dict(sparse_manual=True, sparse_length=16)])
def test_encode_images_matches_jax(image_setup, cfg):
    jenc, enc, _, _ = image_setup
    if cfg:
        jenc = JEncoder(jenc.params, jenc.arch, jenc.tokenizer,
                        jenc.template, JSparseConfig(**cfg))
        enc = OnlineQueryEncoder(enc.params, enc.arch, enc.tokenizer,
                                 enc.template, SparseConfig(**cfg),
                                 device="cpu")
    images = _images(1, SIZES)
    dense, terms = enc.encode_images(images, pad_to=8)
    jdense, jterms = jenc.encode_images(images, pad_to=8)
    assert dense.shape == (len(images), enc.arch.text.hidden_size)
    np.testing.assert_allclose(dense, jdense, atol=1e-5, rtol=1e-5)
    assert len(terms) == len(images)
    for got, ref in zip(terms, jterms):
        _assert_same_terms(got, ref)


def _assert_same_up_to_ties(got, want):
    g = {(d, round(float(s), 4)) for d, s in got}
    w = {(d, round(float(s), 4)) for d, s in want}
    assert sorted(s for _, s in g) == sorted(s for _, s in w)
    if len(got) < DEPTH:
        assert g == w
        return
    cut = min(s for _, s in g)
    assert {p for p in g if p[1] > cut} == {p for p in w if p[1] > cut}


def _serve(service_cls, index, enc, images, texts, **kw):
    svc = service_cls(impact_index=index, query_encoder=enc,
                      depth_levels=(DEPTH,), max_batch=4, max_wait_ms=20.0,
                      **kw)
    try:
        futs = [svc.search_async(image=im) for im in images]
        futs += [svc.search_async(text=t) for t in texts]
        return [f.result(120) for f in futs]
    finally:
        svc.close()


@pytest.mark.parametrize("backend", ["taat", "matmul"])
def test_image_search_matches_jax_service(image_setup, backend):
    jenc, enc, jindex, index = image_setup
    images = _images(9, SIZES[:4]) + _images(2, SIZES[2:])
    texts = CAPTIONS[:2]
    want = _serve(JService, jindex, jenc, images, texts)
    got = _serve(RetrievalService, index, enc, images, texts,
                 backend=backend)
    hits = 0
    for g, w in zip(got, want):
        _assert_same_up_to_ties(g, w)
        assert [s for _, s in g] == sorted((s for _, s in g), reverse=True)
        hits += len(g)
    assert hits > 0
    # an indexed image retrieves itself first
    n_cap = len(CAPTIONS)
    assert [r[0][0] for r in got[:4]] == [f"d{n_cap + i}" for i in range(4)]


def test_image_query_validation(image_setup):
    _, enc, _, index = image_setup
    svc = RetrievalService(impact_index=index, query_encoder=enc,
                           depth_levels=(DEPTH,), max_batch=2,
                           max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
            svc.search(image=np.zeros((8, 8), np.float32))
        with pytest.raises(ValueError, match="text OR image"):
            svc.search(text="a dog", image=np.zeros((8, 8, 3)))
        with pytest.raises(ValueError, match="not both"):
            svc.search(image=np.zeros((8, 8, 3)), terms={1: 1.0})
    finally:
        svc.close()
    bare = RetrievalService(impact_index=index, depth_levels=(DEPTH,),
                            max_batch=2)
    try:
        with pytest.raises(ValueError, match="query_encoder"):
            bare.search(image=np.zeros((8, 8, 3)))
    finally:
        bare.close()
    with pytest.raises(ValueError, match="batch of"):
        enc.encode_images(_images(0, SIZES[:3]), pad_to=2)
