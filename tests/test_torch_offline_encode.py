"""PyTorch port: offline ``encode_examples`` and the artifact writers
against the JAX package's, on a flickr-layout CSV this file writes (seeded
captions) and tiny models whose weights the JAX package draws and
``models/convert_jax.from_jax_params`` carries across.

Covered: text documents (filtered and unfiltered, manual and not,
``num_expanded_tokens`` 0 and 5), text queries, fixed-grid and anyres
image documents, a last partial batch, ``EncodeResult``'s string forms,
``write_artifacts`` / ``read_query_tsv`` and ``artifact_dir``, and each
package loading the other's pickles and jsonl.

Tolerances: ids, selected token ids and their integer weights, the string
forms and the written jsonl / query.tsv are exact; text terms are equal
arrays, image terms equal sets of ``(token id, weight)`` over the positive
weights (tied logits may leave the top-k in either order); dense vectors
agree to f32 ``atol=rtol=1e-5`` (XLA and PyTorch sum the towers' matmuls in
different orders).
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.data.karpathy import CrossModalCorpus as JCorpus
from mllm_sparse_retrieval_tpu.index.dense import (
    DenseFlatIndex as JDenseFlatIndex)
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models import templates as jtemplates
from mllm_sparse_retrieval_tpu.models.llama import LlamaConfig as JLlamaConfig
from mllm_sparse_retrieval_tpu.models.mllm import MLLMConfig as JMLLMConfig
from mllm_sparse_retrieval_tpu.models.tokenizer import (
    WordPieceLiteTokenizer as JTokenizer)
from mllm_sparse_retrieval_tpu.models.vit import ViTConfig as JViTConfig
from mllm_sparse_retrieval_tpu.pipelines import encode as jencode
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, SparseConfig)
from mllm_sparse_retrieval_tpu_torch.data import CrossModalCorpus
from mllm_sparse_retrieval_tpu_torch.index import DenseFlatIndex, ImpactIndex
from mllm_sparse_retrieval_tpu_torch.models import templates
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig
from mllm_sparse_retrieval_tpu_torch.pipelines import encode as pencode
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(tiny_vocab_size=256, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4)
VIT = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
           num_heads=4, feature_layer=-2)
TEXT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, rope_theta=10000.0)
PINPOINTS = ((28, 56), (56, 28), (56, 56))
SIZES = [(64, 64), (40, 120), (120, 40), (30, 30), (90, 60), (61, 200)]
WORDS = ["dog", "cat", "red", "bus", "man", "kite", "boat", "lake", "snow",
         "child", "bird", "wire", "grass", "city", "tree", "ball", "The",
         "A", "people", "ride", "bikes", "play", "holds", "near"]
N_IMAGES, CAPS_PER_IMAGE, BATCH = 10, 3, 4   # 30 captions: partial batches


def write_flickr(root, seed):
    rng = np.random.default_rng(seed)
    d = root / "flickr"
    d.mkdir(parents=True, exist_ok=True)
    lines = ["imgid,filename,caption,sentid"]
    sent = 0
    for img in range(N_IMAGES):
        for _ in range(CAPS_PER_IMAGE):
            cap = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 8))))
            if sent % 7 == 3:
                cap = "a the of"     # stopwords only: no candidate, fallback
            lines.append(f"{700 + img},{700 + img}.jpg,{cap},{sent}")
            sent += 1
    (d / "flickr_test.csv").write_text("\n".join(lines) + "\n")


def raw_loader(ex):
    """Seeded raw [H, W, 3] images of SIZES, keyed by img_id."""
    i = int(ex.img_id)
    rng = np.random.default_rng(i)
    return rng.uniform(size=SIZES[i % len(SIZES)] + (3,)).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_flickr(root, seed=11)
    corpus = CrossModalCorpus("flickr", "test", str(root))
    jcorpus = JCorpus("flickr", "test", str(root))
    caps = list(corpus.text_dict.values())
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
    fixed = dict(j=(jparams, jarch, jtok, jtmpl),
                 p=(params, spec.arch, tok, spec.template))
    # tiny LLaVA-NeXT anyres model
    atok = WordPieceLiteTokenizer.from_corpus_captions(caps, vocab_size=96)
    jatok = JTokenizer.from_corpus_captions(caps, vocab_size=96)
    jaarch = JMLLMConfig(vision=JViTConfig(**VIT), text=JLlamaConfig(**TEXT),
                         image_token_id=4, grid_pinpoints=PINPOINTS)
    aarch = MLLMConfig(vision=ViTConfig(**VIT), text=LlamaConfig(**TEXT),
                       image_token_id=4, grid_pinpoints=PINPOINTS)
    japarams = jmllm.init_params(jax.random.PRNGKey(1), jaarch)
    aparams = from_jax_params(jax.tree_util.tree_map(np.asarray, japarams),
                              device="cpu")
    anyres = dict(j=(japarams, jaarch, jatok, jtemplates.TINY),
                  p=(aparams, aarch, atok, templates.TINY))
    return dict(root=root, corpus=corpus, jcorpus=jcorpus, fixed=fixed,
                anyres=anyres)


def _encode(setup, model, examples, jexamples, encode_type, cfg,
            is_query=False, pixel_loader=None):
    jp, ja, jt, jtm = setup[model]["j"]
    pp, pa, pt, ptm = setup[model]["p"]
    want = jencode.encode_examples(
        jexamples, jp, ja, jt, jtm, encode_type=encode_type,
        sparse_cfg=JSparseConfig(**cfg), batch_size=BATCH,
        is_query=is_query, pixel_loader=pixel_loader)
    got = pencode.encode_examples(
        examples, pp, pa, pt, ptm, encode_type=encode_type,
        sparse_cfg=SparseConfig(**cfg), batch_size=BATCH,
        is_query=is_query, pixel_loader=pixel_loader, device="cpu")
    return got, want


def _assert_same_result(got, want, exact_terms=True):
    assert got.ids == want.ids
    assert got.dense.dtype == np.float32
    assert got.dense.shape == want.dense.shape
    np.testing.assert_allclose(got.dense, np.asarray(want.dense),
                               atol=1e-5, rtol=1e-5)
    assert len(got.selected_terms) == len(want.selected_terms)
    for g, w in zip(got.selected_terms, want.selected_terms):
        if exact_terms:
            np.testing.assert_array_equal(g.token_ids, w.token_ids)
            np.testing.assert_array_equal(g.weights, w.weights)
        else:
            gs = {(int(i), int(v)) for i, v in zip(g.token_ids, g.weights)
                  if v > 0}
            ws = {(int(i), int(v)) for i, v in zip(w.token_ids, w.weights)
                  if v > 0}
            assert gs == ws and gs
    if exact_terms:
        assert got.sparse_vectors == want.sparse_vectors
        assert got.query_weights == want.query_weights


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(is_filtered=False),
    dict(sparse_manual=True, sparse_length=16),
    dict(num_expanded_tokens=5),
    dict(is_filtered=False, sparse_manual=True, sparse_length=12,
         num_expanded_tokens=3),
])
def test_text_documents_match_jax(setup, cfg):
    ex = setup["corpus"].examples_full()
    jex = setup["jcorpus"].examples_full()
    got, want = _encode(setup, "fixed", ex, jex, "text", cfg)
    assert len(got.ids) == N_IMAGES * CAPS_PER_IMAGE   # last batch partial
    assert got.query_weights == []
    _assert_same_result(got, want)


@pytest.mark.parametrize("cfg", [dict(), dict(num_expanded_tokens=4)])
def test_text_queries_match_jax(setup, cfg):
    ex = setup["corpus"].examples_full()[:13]
    jex = setup["jcorpus"].examples_full()[:13]
    got, want = _encode(setup, "fixed", ex, jex, "text", cfg, is_query=True)
    assert got.sparse_vectors == [] and got.query_weights
    _assert_same_result(got, want)


@pytest.mark.parametrize("model,cfg", [
    ("fixed", dict()),
    ("fixed", dict(sparse_manual=True, sparse_length=20,
                   num_expanded_tokens=3)),
    ("anyres", dict()),
    ("anyres", dict(num_expanded_tokens=4)),
])
def test_image_documents_match_jax(setup, model, cfg):
    ex = setup["corpus"].examples_single()
    jex = setup["jcorpus"].examples_single()
    loader = raw_loader if model == "anyres" else None
    got, want = _encode(setup, model, ex, jex, "image", cfg,
                        pixel_loader=loader)
    assert got.ids == [e.img_id for e in ex]    # 10 images, batches of 4
    _assert_same_result(got, want, exact_terms=False)
    # the string form of each doc is built from its own terms
    id_to_token = {v: k for k, v in setup[model]["p"][2].get_vocab().items()}
    for t, vec in zip(got.selected_terms, got.sparse_vectors):
        assert vec == jencode.doc_string_vector(t, id_to_token, True)


def test_partial_batch_pad_rows_are_dropped(setup):
    """The last batch repeats its last example; those pad rows never reach
    the result, and each example's output does not depend on its batch."""
    pp, pa, pt, ptm = setup["fixed"]["p"]
    ex = setup["corpus"].examples_full()[:7]
    kw = dict(encode_type="text", sparse_cfg=SparseConfig(), device="cpu")
    by4 = pencode.encode_examples(ex, pp, pa, pt, ptm, batch_size=4, **kw)
    one = pencode.encode_examples(ex[5:7], pp, pa, pt, ptm, batch_size=4,
                                  **kw)
    assert by4.ids == [e.text_id for e in ex]
    assert by4.dense.shape == (7, pa.text.hidden_size)
    np.testing.assert_allclose(by4.dense[5:], one.dense, atol=1e-6)
    padded = pencode._pad_batch_examples(ex[:3], 5)
    assert padded == ex[:3] + [ex[2], ex[2]]


def test_artifacts_cross_load(setup, tmp_path):
    ex = setup["corpus"].examples_full()
    jex = setup["jcorpus"].examples_full()
    got, want = _encode(setup, "fixed", ex, jex, "text", dict())
    qgot, qwant = _encode(setup, "fixed", ex[:9], jex[:9], "text", dict(),
                          is_query=True)
    cfg = SparseConfig(num_expanded_tokens=2)
    assert pencode.artifact_dir("b", "m", "flickr", "text", cfg, lora=True) \
        == jencode.artifact_dir("b", "m", "flickr", "text",
                                JSparseConfig(num_expanded_tokens=2), True)
    dirs = {}
    for pkg, res, qres, writer in (
            ("p", got, qgot, pencode.write_artifacts),
            ("j", want, qwant, jencode.write_artifacts)):
        dd, sd = tmp_path / pkg / "dense", tmp_path / pkg / "sparse"
        writer(res, str(dd), str(sd), shard_index=1)
        writer(qres, str(dd), str(sd), is_query=True)
        dirs[pkg] = (dd, sd)
    pd, ps = dirs["p"]
    jd, js = dirs["j"]
    # the port's pickles hold numpy and a list, never tensors
    with open(pd / "corpus_1.pkl", "rb") as f:
        reps, ids = pickle.load(f)
    assert type(reps) is np.ndarray and reps.dtype == np.float32
    assert type(ids) is list and ids == want.ids
    # jsonl and query.tsv are byte-equal
    assert (ps / "corpus_1.jsonl").read_text() == \
        (js / "corpus_1.jsonl").read_text()
    assert (ps / "query.tsv").read_text() == (js / "query.tsv").read_text()
    docs = [json.loads(line) for line in
            (ps / "corpus_1.jsonl").read_text().splitlines()]
    assert [d["id"] for d in docs] == got.ids
    assert [d["vector"] for d in docs] == got.sparse_vectors
    # read_query_tsv: each package reads either file to the same dicts
    q = pencode.read_query_tsv(str(ps / "query.tsv"))
    assert q == jencode.read_query_tsv(str(js / "query.tsv"))
    assert q == {qid: w for qid, w in zip(qgot.ids, qgot.query_weights)
                 if w}
    # dense pickles load in the other package
    for mine, theirs in ((pd, jd), (jd, pd)):
        a = DenseFlatIndex.load(str(mine), device="cpu")
        b = JDenseFlatIndex.load(str(theirs))
        assert a.lookup == b.lookup
        np.testing.assert_allclose(np.concatenate(a._chunks),
                                   np.concatenate(b._chunks),
                                   atol=1e-5, rtol=1e-5)
    qa = DenseFlatIndex.load(os.path.join(jd, "query.pkl"), device="cpu")
    assert qa.lookup == qwant.ids
    # the jsonl builds the same index in both packages
    mine = ImpactIndex.from_jsonl([str(ps / "corpus_1.jsonl")],
                                  use_native=False, device="cpu")
    theirs = JImpactIndex.from_jsonl([str(js / "corpus_1.jsonl")],
                                     use_native=False)
    assert mine.term_to_idx == theirs.term_to_idx
    assert mine.doc_ids == theirs.doc_ids
    for name in ("doc_terms", "doc_weights", "csr_offsets", "csr_docs",
                 "csr_weights"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(theirs, name))


def test_encode_examples_rejects_unknown_type(setup):
    pp, pa, pt, ptm = setup["fixed"]["p"]
    with pytest.raises(ValueError, match="encode_type"):
        pencode.encode_examples(setup["corpus"].examples_full()[:2], pp, pa,
                                pt, ptm, encode_type="audio",
                                sparse_cfg=SparseConfig(), device="cpu")
