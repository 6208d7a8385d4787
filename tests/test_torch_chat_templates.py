"""PyTorch port, the chat-template families' shared pieces against the JAX
package: the prompt templates (rendered prompts and ``expand_image`` of
every family, string-equal), ``resolve_template`` through a stub HF
tokenizer with a chat template (string-equal), the registry's archs and
templates (equal), M-RoPE ``rope_tables`` with ``[B, T]`` and ``[3, B, T]``
position ids (f32, within ``1e-6 * (1 + |jax|)``: the same products, the
same cos / sin on another backend) and the decoder with M-RoPE ids (f32,
``atol=rtol=1e-5``). Training both families is held to the JAX trainer in
``test_torch_train_chat.py``.

It also holds the helpers that ``test_torch_internvl.py`` and
``test_torch_qwen_vl.py`` use to hold the served slice and
``encode_examples`` of a family to the JAX package: ``chat_tokenizers``
(the synthetic tokenizer of each package wrapped in ``chip_smoke``'s
``ChatTokenizer``, which gives the families' special tokens as single ids,
as a Hugging Face tokenizer's added tokens are), ``family_setup``,
``assert_served_equal`` and ``assert_encode_examples_equal``. Their
tolerances: dense reps ``atol=rtol=1e-5`` (f32; XLA and PyTorch sum in
other orders); selected terms equal as sets of positive ``(id, weight)``;
served results equal as sets of ``(doc, round(score, 4))``, docs tied at
the depth cut aside.
"""


import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ChatTokenizer as ChatTok
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.data.karpathy import Example as JExample
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.models import convert as jconvert
from mllm_sparse_retrieval_tpu.pipelines import encode as jencode
from mllm_sparse_retrieval_tpu.serving import (
    OnlineQueryEncoder as JEncoder, RetrievalService as JService)
from mllm_sparse_retrieval_tpu.sparse import (
    canonical_id_map as j_canonical_id_map)
from mllm_sparse_retrieval_tpu.models import llama as jllama
from mllm_sparse_retrieval_tpu.models import registry as jregistry
from mllm_sparse_retrieval_tpu.models import templates as jtemplates
from mllm_sparse_retrieval_tpu.models.llama import LlamaConfig as JLlama
from mllm_sparse_retrieval_tpu.models.tokenizer import (
    HFTokenizerAdapter as JAdapter)
from mllm_sparse_retrieval_tpu.models.tokenizer import (
    WordPieceLiteTokenizer as JTokenizer)
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelFamily, SparseConfig)
from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.models import (
    convert, llama, registry, templates)
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    HFTokenizerAdapter, WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.pipelines import encode as pencode
from mllm_sparse_retrieval_tpu_torch.serving import (
    OnlineQueryEncoder, RetrievalService)
from mllm_sparse_retrieval_tpu_torch.sparse import (
    SelectedTerms, canonical_id_map)

FAMILIES = ("LLAMA3", "LLAVA_V1_5", "QWEN2_5_VL", "INTERNVL2_5", "TINY")
ROPE_TOL = 1e-6
TOL = dict(atol=1e-5, rtol=1e-5)
DEPTH = 10
CAPTIONS = ["a dog runs on grass", "a cat sits on a mat",
            "two people ride bikes", "a red bus in the city",
            "a man holds a kite", "three birds on a wire",
            "a boat on the lake", "children play in the snow"]
SIZES = [(64, 64), (40, 120), (120, 40), (30, 30), (90, 60), (61, 200)]
TOKENIZER_VOCAB, MODEL_VOCAB = 120, 160


def chat_tokenizers():
    """``(jax_tok, port_tok)``: the same ``ChatTok`` over each package's
    synthetic tokenizer."""
    jtok = ChatTok(JTokenizer.from_corpus_captions(
        CAPTIONS, vocab_size=TOKENIZER_VOCAB))
    tok = ChatTok(WordPieceLiteTokenizer.from_corpus_captions(
        CAPTIONS, vocab_size=TOKENIZER_VOCAB))
    assert tok.get_vocab() == jtok.get_vocab()
    assert tok.vocab_size <= MODEL_VOCAB
    return jtok, tok


def images(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=s + (3,)).astype(np.float32) for s in sizes]


def noisy(tree, seed, scale=0.05):
    """The JAX tree as numpy with seeded noise on every leaf, so the zero
    biases and unit norms of the JAX init are exercised too."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=np.shape(a)))
        .astype(np.float32), tree)


def port_arch(jarch):
    """The port's arch of a JAX arch, through the two packages' manifests
    (which must round-trip to the same manifest)."""
    manifest = jconvert.arch_to_manifest(jarch)
    arch = convert.arch_from_manifest(manifest)
    assert convert.arch_to_manifest(arch) == manifest
    return arch


def family_setup(jarch, jparams, template_name):
    """``(jax encoder, port encoder, jax index, port index)`` of a family
    on the same weights, tokenizer and template; the corpus is the JAX
    encoder's terms of ``CAPTIONS`` and of four images."""
    jtok, tok = chat_tokenizers()
    params = from_jax_params(jparams, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    jenc = JEncoder(jparams, jarch, jtok, getattr(jtemplates, template_name),
                    JSparseConfig())
    enc = OnlineQueryEncoder(params, port_arch(jarch), tok,
                             getattr(templates, template_name),
                             SparseConfig(), device="cpu")
    jterms = jenc.encode_texts(CAPTIONS, pad_to=8)[1]
    jterms += jenc.encode_images(images(9, SIZES[:4]), pad_to=4)[1]
    doc_ids = [f"d{i}" for i in range(len(jterms))]
    jindex = JImpactIndex.from_selected_terms(
        doc_ids, jterms, j_canonical_id_map(jtok.get_vocab(), True))
    index = ImpactIndex.from_selected_terms(
        doc_ids, [SelectedTerms(t.token_ids, t.weights) for t in jterms],
        canonical_id_map(tok.get_vocab(), True), device="cpu")
    return jenc, enc, jindex, index


def _same_terms(got, ref):
    """Equal sets of positive (id, weight); their size."""
    g = {(int(i), int(w)) for i, w in zip(got.token_ids, got.weights)
         if w > 0}
    r = {(int(i), int(w)) for i, w in zip(ref.token_ids, ref.weights)
         if w > 0}
    assert g == r
    return len(g)


def _same_up_to_ties(got, want):
    g = {(d, round(float(s), 4)) for d, s in got}
    w = {(d, round(float(s), 4)) for d, s in want}
    assert sorted(s for _, s in g) == sorted(s for _, s in w)
    if len(got) < DEPTH:
        assert g == w
        return
    cut = min(s for _, s in g)
    assert {p for p in g if p[1] > cut} == {p for p in w if p[1] > cut}


def assert_served_equal(setup):
    """Encoded reps, then text and image queries served through each
    package's ``RetrievalService`` (the port's on the TAAT backend's plain
    version): the same non-empty results up to ties."""
    jenc, enc, jindex, index = setup
    ims = images(9, SIZES[:4]) + images(2, SIZES[2:])
    dense, terms = enc.encode_images(ims, pad_to=8)
    jdense, jterms = jenc.encode_images(ims, pad_to=8)
    np.testing.assert_allclose(dense, jdense, **TOL)
    for g, w in zip(terms, jterms):
        assert _same_terms(g, w)

    def serve(cls, idx, e, **kw):
        svc = cls(impact_index=idx, query_encoder=e, depth_levels=(DEPTH,),
                  max_batch=4, max_wait_ms=20.0, **kw)
        try:
            futs = [svc.search_async(image=im) for im in ims]
            futs += [svc.search_async(text=t) for t in CAPTIONS[:3]]
            return [f.result(120) for f in futs]
        finally:
            svc.close()

    want = serve(JService, jindex, jenc)
    got = serve(RetrievalService, index, enc, backend="taat")
    for g, w in zip(got, want):
        assert g
        _same_up_to_ties(g, w)


def assert_encode_examples_equal(jarch, jparams, template_name):
    """``encode_examples`` of captions and of (synthetic, absent-file)
    images, as documents, in both packages: the same ids, dense reps and
    terms."""
    jtok, tok = chat_tokenizers()
    params = from_jax_params(jparams, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    rows = [(c, f"/absent/{i}.jpg", f"t{i}", f"i{i}")
            for i, c in enumerate(CAPTIONS[:5])]
    for kind in ("text", "image"):
        want = jencode.encode_examples(
            [JExample(*r) for r in rows], jparams, jarch, jtok,
            getattr(jtemplates, template_name), encode_type=kind,
            sparse_cfg=JSparseConfig(), batch_size=4)
        got = pencode.encode_examples(
            [Example(*r) for r in rows], params, port_arch(jarch), tok,
            getattr(templates, template_name), encode_type=kind,
            sparse_cfg=SparseConfig(), batch_size=4, device="cpu")
        assert got.ids == want.ids
        np.testing.assert_allclose(got.dense, np.asarray(want.dense), **TOL)
        assert sum(_same_terms(g, w) for g, w in
                   zip(got.selected_terms, want.selected_terms))


@pytest.mark.parametrize("name", FAMILIES)
def test_templates_render_as_the_jax_ones(name):
    port, jax_t = getattr(templates, name), getattr(jtemplates, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_t)
    for one_word in (True, False):
        assert port.image_prompt(one_word) == jax_t.image_prompt(one_word)
        assert port.text_prompt(one_word) == jax_t.text_prompt(one_word)
    prompt = port.text_prompt()
    assert port.fill_text(prompt, "a dog") == jax_t.fill_text(prompt,
                                                              "a dog")
    for n in (0, 1, 5):
        assert port.expand_image(port.image_prompt(), n) == \
            jax_t.expand_image(jax_t.image_prompt(), n)
    assert templates._CHAT_MESSAGES == jtemplates._CHAT_MESSAGES


class _StubHF:
    """A stand-in HF tokenizer with a ChatML chat template: renders
    messages whose content is a string or a list of parts, as the Qwen and
    InternVL templates do, image parts as the family's placeholder."""

    pad_token_id = 0

    def __init__(self, image_slot, chat_template="{{ chatml }}",
                 system=None):
        self.chat_template = chat_template
        self.image_slot = image_slot
        self.system = system

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=True):
        assert tokenize is False and add_generation_prompt is True
        out = ""
        if self.system:
            out += f"<|im_start|>system\n{self.system}<|im_end|>\n"
        for m in messages:
            content = m["content"]
            if isinstance(content, list):
                content = "".join(self.image_slot if p["type"] == "image"
                                  else p["text"] for p in content)
            out += f"<|im_start|>{m['role']}\n{content}<|im_end|>\n"
        return out + "<|im_start|>assistant\n"


@pytest.mark.parametrize("name,slot,system", [
    ("QWEN2_5_VL", "<|vision_start|><|image_pad|><|vision_end|>",
     "You are a helpful assistant."),
    ("QWEN2_5_VL", "<|image_pad|>", None),
    ("INTERNVL2_5", "<image>", None),
])
def test_resolve_template_renders_through_a_chat_template(name, slot,
                                                          system):
    port, jax_t = getattr(templates, name), getattr(jtemplates, name)
    stub = _StubHF(slot, system=system)
    adapter, jadapter = HFTokenizerAdapter(stub), JAdapter(stub)
    assert adapter.hf_tokenizer is stub
    got = templates.resolve_template(port, adapter)
    want = jtemplates.resolve_template(jax_t, jadapter)
    assert isinstance(got, templates._ResolvedTemplate)
    for one_word in (True, False):
        assert got.image_prompt(one_word) == want.image_prompt(one_word)
        assert got.text_prompt(one_word) == want.text_prompt(one_word)
    assert got.expand_image(got.image_prompt(), 3) == \
        want.expand_image(want.image_prompt(), 3)
    assert "<image>" in got.image_prompt() and "<sent>" in got.text_prompt()


def test_resolve_template_keeps_the_template_without_a_chat_template():
    stub = _StubHF("<|image_pad|>", chat_template=None)
    for tok in (None, HFTokenizerAdapter(stub)):
        assert templates.resolve_template(templates.QWEN2_5_VL, tok) is \
            templates.QWEN2_5_VL
    # string-wrapper families never re-render
    with_template = HFTokenizerAdapter(_StubHF("<image>"))
    for name in ("LLAMA3", "LLAVA_V1_5", "TINY"):
        t = getattr(templates, name)
        assert templates.resolve_template(t, with_template) is t


@pytest.mark.parametrize("name", [
    "_qwen2_5_vl_3b_arch", "_qwen2_5_vl_7b_arch", "_internvl2_5_arch",
    "_internvl2_5_4b_arch", "_tiny_qwen_debug_arch"])
def test_registry_archs_equal_the_jax_registry(name):
    want = dataclasses.asdict(getattr(jregistry, name)())
    if name == "_qwen2_5_vl_7b_arch":
        # the one departure: the JAX 7B keeps the 3B merger's output width,
        # which cannot splice into its 3,584-wide backbone
        assert want["vision"]["out_hidden_size"] == 2048 != \
            want["text"]["hidden_size"]
        want["vision"]["out_hidden_size"] = want["text"]["hidden_size"]
    assert dataclasses.asdict(getattr(registry, name)()) == want


@pytest.mark.parametrize("family", ["QWEN2_5_VL", "INTERNVL2_5",
                                    "TINY_QWEN_DEBUG"])
def test_family_specs_equal_the_jax_registry(family):
    spec = registry.get_family_spec(ModelFamily[family])
    jspec = jregistry.get_family_spec(JFamily[family])
    assert dataclasses.asdict(spec.arch) == dataclasses.asdict(jspec.arch)
    assert dataclasses.asdict(spec.template) == \
        dataclasses.asdict(jspec.template)
    assert spec.hf_repo == jspec.hf_repo


def _mrope_cfgs():
    kw = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=128, rope_theta=10000.0,
              qkv_bias=True, mrope_section=(4, 2, 2))
    return LlamaConfig(**kw), JLlama(**kw)


def _pos3(seed, b, t):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.integers(0, 3, size=(b, t)), axis=1)
    return np.stack([base, base + rng.integers(0, 9, size=(b, t)),
                     base + rng.integers(0, 9, size=(b, t))]).astype(np.int64)


@pytest.mark.parametrize("kind", ["none", "2d", "3d"])
def test_rope_tables_match_jax(kind):
    cfg, jcfg = _mrope_cfgs()
    pos = {"none": None, "2d": _pos3(0, 3, 20)[1],
           "3d": _pos3(0, 3, 20)}[kind]
    cos, sin = llama.rope_tables(
        cfg, 20, None if pos is None else torch.from_numpy(pos),
        device="cpu")
    jcos, jsin = jllama.rope_tables(jcfg, 20, pos)
    for got, want in ((cos, jcos), (sin, jsin)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.all(np.abs(got.numpy() - want)
                      <= ROPE_TOL * (1 + np.abs(want)))


def test_rope_tables_refuse_bad_sections():
    cfg, _ = _mrope_cfgs()
    pos = torch.from_numpy(_pos3(1, 2, 8))
    with pytest.raises(ValueError, match="mrope_section"):
        llama.rope_tables(dataclasses.replace(cfg, mrope_section=None), 8,
                          pos, device="cpu")
    with pytest.raises(ValueError, match="sum"):
        llama.rope_tables(dataclasses.replace(cfg, mrope_section=(4, 4, 4)),
                          8, pos, device="cpu")


def test_decoder_with_mrope_ids_matches_jax():
    cfg, jcfg = _mrope_cfgs()
    jparams = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")["text"]
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(3, 20, 64)).astype(np.float32)
    mask = np.ones((3, 20), np.int32)
    mask[1, 14:] = 0
    pos = _pos3(5, 3, 20)
    got = llama.apply(params, torch.from_numpy(emb), torch.from_numpy(mask),
                      cfg, position_ids=torch.from_numpy(pos))
    want = jllama.apply(jparams, jnp.asarray(emb), jnp.asarray(mask), jcfg,
                        position_ids=jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # equal components reduce M-RoPE to 1-D RoPE
    flat = np.broadcast_to(np.arange(20), (3, 3, 20)).copy()
    got3 = llama.apply(params, torch.from_numpy(emb), torch.from_numpy(mask),
                       cfg, position_ids=torch.from_numpy(flat))
    got1 = llama.apply(params, torch.from_numpy(emb), torch.from_numpy(mask),
                       cfg)
    np.testing.assert_allclose(got3.numpy(), got1.numpy(), **TOL)


def test_llama_config_still_refuses_moe():
    """``LlamaConfig`` takes an MoE FFN now (``parallel/ep.py``); what still
    refuses it is the MLLM wrapper, with the JAX package's ``ValueError``
    (its one-tensor contract cannot carry the aux loss)."""
    from mllm_sparse_retrieval_tpu_torch.models.mllm import (
        MLLMConfig, forward_hidden)
    from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig
    from mllm_sparse_retrieval_tpu_torch.parallel import MoEConfig

    cfg = LlamaConfig(moe=MoEConfig(num_experts=8, top_k=2))
    assert cfg.moe.num_experts == 8
    arch = MLLMConfig(vision=ViTConfig(), text=cfg)
    with pytest.raises(ValueError, match="MoE text configs"):
        forward_hidden({"text": {"embed": torch.zeros(4, 2)}}, arch,
                       torch.zeros((1, 2), dtype=torch.long),
                       torch.ones((1, 2)))
    assert LlamaConfig(mrope_section=(16, 24, 24)).mrope_section == \
        (16, 24, 24)
