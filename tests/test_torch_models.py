"""PyTorch port, text tower: layers, llama, reps and mllm.encode against the
JAX package on the tiny_debug text config, on weights carried across with
``from_jax_params``.

Tolerances (f32 on the CPU): ``atol=rtol=1e-5`` on hidden states, dense
reps and the layer outputs, ``1e-4`` on sparse logits. XLA and PyTorch sum
the matmuls in different orders, which moves f32 results by a few ulps per
layer; the sparse head adds a hidden-size-long dot product on top of the
hidden state's error, so it gets one more decade.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import RepsLoc as JRepsLoc
from mllm_sparse_retrieval_tpu.models import layers as JL
from mllm_sparse_retrieval_tpu.models import llama as jllama
from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models import reps as jreps
from mllm_sparse_retrieval_tpu.models.registry import (
    tiny_debug_arch as j_tiny_arch)
from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, RepsLoc
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.models import llama, mllm, reps
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from mllm_sparse_retrieval_tpu_torch.models.registry import (
    build_model, get_family_spec, tiny_debug_arch)
from mllm_sparse_retrieval_tpu_torch.configs import ModelFamily

TOL = dict(atol=1e-5, rtol=1e-5)
SPARSE_TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(tiny_vocab_size=256, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4)


@pytest.fixture(scope="module")
def tower():
    j_arch = j_tiny_arch(JModelConfig(dtype="float32", **TINY))
    arch = tiny_debug_arch(ModelConfig(dtype="float32", **TINY))
    jparams = jmllm.init_params(jax.random.PRNGKey(0), j_arch, jnp.float32)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(0)
    b, t = 3, 16
    ids = rng.integers(0, 256, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, 11:] = 0
    mask[2, 5:] = 0
    return j_arch, arch, jparams, params, ids, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("family", ["tiny_debug", "llava_next_llama3"])
def test_arch_copies_match_jax(family):
    from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
    from mllm_sparse_retrieval_tpu.models.registry import (
        get_family_spec as j_spec)
    spec = get_family_spec(ModelFamily(family), ModelConfig(**TINY))
    jspec = j_spec(JFamily(family), JModelConfig(**TINY))
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "num_kv_heads", "intermediate_size", "max_seq_len",
              "rope_theta", "rms_eps", "qkv_bias", "tie_lm_head",
              "head_dim"):
        assert getattr(spec.arch.text, f) == getattr(jspec.arch.text, f), f
    assert spec.arch.image_token_id == jspec.arch.image_token_id
    assert spec.template.text_prompt() == jspec.template.text_prompt()


def test_rmsnorm_rope_attention_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm(_t(x), {"scale": _t(scale)}, 1e-5).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), {"scale": jnp.asarray(scale)},
                              1e-5)), **TOL)
    cos, sin = L.rope_frequencies(16, 8, 500000.0, device="cpu")
    jcos, jsin = JL.rope_frequencies(16, 8, 500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(
        L.apply_rope(_t(x), cos, sin).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jcos, jsin)), **TOL)
    k = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    pad = np.ones((2, 8), np.int32)
    pad[1, 5:] = 0
    got = L.attention(_t(x), _t(k), _t(v), L.causal_padding_mask(_t(pad)))
    ref = JL.attention(jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                       JL.causal_padding_mask(jnp.asarray(pad)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_llama_hidden_matches_jax(tower):
    j_arch, arch, jparams, params, ids, mask = tower
    embeds = llama.embed_tokens(params["text"], _t(ids).long())
    got = llama.apply(params["text"], embeds, _t(mask), arch.text)
    jemb = jllama.embed_tokens(jparams["text"], jnp.asarray(ids))
    ref = jllama.apply(jparams["text"], jemb, jnp.asarray(mask), j_arch.text)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("loc", ["before_pad", "after_pad"])
def test_mllm_encode_matches_jax(tower, loc):
    j_arch, arch, jparams, params, ids, mask = tower
    sparse, dense = mllm.encode(params, arch, _t(ids).long(), _t(mask), None,
                                RepsLoc(loc))
    jsparse, jdense = jmllm.encode(jparams, j_arch, jnp.asarray(ids),
                                   jnp.asarray(mask), None, JRepsLoc(loc))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), **TOL)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse),
                               **SPARSE_TOL)
    assert sparse.dtype == torch.float32


def test_reps_helpers_match_jax(tower):
    *_, ids, mask = tower
    for loc in RepsLoc:
        np.testing.assert_array_equal(
            reps.select_rep_positions(_t(mask), loc).numpy(),
            np.asarray(jreps.select_rep_positions(jnp.asarray(mask),
                                                  JRepsLoc(loc.value))))
    e = np.random.default_rng(2).normal(size=(4, 32)).astype(np.float32)
    e[1] = 0.0
    np.testing.assert_allclose(reps.normalize(_t(e)).numpy(),
                               np.asarray(jreps.normalize(jnp.asarray(e))),
                               **TOL)


def test_bf16_head_logits_accumulate_in_f32():
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(32, 20000)).astype(np.float32))
    hb, wb = h.bfloat16(), w.bfloat16()
    got = reps.head_logits(hb, wb)
    ref = hb.double() @ wb.double()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                               rtol=1e-5)


def test_build_model_tiny_and_real_families():
    caps = ["a dog runs in the park", "two cats sleep on a red sofa"]
    params, arch, tok, tmpl = build_model(
        ModelConfig(dtype="float32", **TINY), captions=caps, seed=3,
        device="cpu")
    ids = torch.tensor([tok.encode(tmpl.fill_text(tmpl.text_prompt(), c))
                        for c in caps[:1]])
    sparse, dense = mllm.encode(params, arch, ids,
                                torch.ones_like(ids, dtype=torch.int32))
    assert sparse.shape == (1, TINY["tiny_vocab_size"])
    assert torch.isfinite(sparse).all() and torch.isfinite(dense).all()
    with pytest.raises(FileNotFoundError, match="converted weights"):
        build_model(ModelConfig(family=ModelFamily.LLAVA_NEXT_LLAMA3),
                    device="cpu")
    with pytest.raises(ValueError, match="raise ModelConfig"):
        build_model(ModelConfig(dtype="float32", **(TINY | dict(
            tiny_vocab_size=8))), captions=caps, device="cpu")


def test_init_params_matches_jax_tree_shapes():
    arch = tiny_debug_arch(ModelConfig(**TINY))
    j_arch = j_tiny_arch(JModelConfig(**TINY))
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = mllm.init_params(arch, gen, device="cpu", dtype=torch.float32)
    jtext = jmllm.init_params(jax.random.PRNGKey(0), j_arch)["text"]
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jtext)
    got = jax.tree_util.tree_map(lambda a: tuple(a.shape), params["text"])
    assert got == shapes
    assert llama.param_count(params["text"]) == sum(
        int(a.size) for a in jax.tree_util.tree_leaves(jtext))
    emb = params["text"]["embed"]
    assert 0.015 < float(emb.std()) < 0.025
    w = params["text"]["blocks"][0]["q"]["w"]
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.1
