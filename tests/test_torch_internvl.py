"""PyTorch port, InternVL2.5 (dynamic tiling, InternViT, pixel shuffle,
the ``mlp1`` projector, the Qwen2-shaped decoder) against the JAX package
on seeded numpy inputs and the same weights (a tiny JAX tree with seeded
noise on every leaf, carried across by ``convert_jax``).

Tolerances: the port's tiling without Pillow is byte-equal to the JAX
package's with it (``dynamic_tile``, ``pad_tiles``, the spec's
``preprocess_example``); the state-dict map gives byte-equal trees; f32
model outputs (InternViT features, ``image_features``, ``encode``'s sparse
and dense reps) agree within ``atol=rtol=1e-5`` (XLA and PyTorch sum the
same products in other orders); the served slice and ``encode_examples``
as in ``test_torch_chat_templates.py``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.data import tiling as jtiling
from mllm_sparse_retrieval_tpu.models import api as japi
from mllm_sparse_retrieval_tpu.models import convert as jconvert
from mllm_sparse_retrieval_tpu.models import internvl as jinternvl
from mllm_sparse_retrieval_tpu.models.internvl import (
    InternViTConfig as JViT, InternVLConfig as JInternVL)
from mllm_sparse_retrieval_tpu.models.llama import LlamaConfig as JLlama
from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, ModelFamily
from mllm_sparse_retrieval_tpu_torch.data import tiling
from mllm_sparse_retrieval_tpu_torch.models import api, convert, internvl
from mllm_sparse_retrieval_tpu_torch.models import registry, templates
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from tests.test_torch_chat_templates import (
    MODEL_VOCAB, SIZES, assert_encode_examples_equal, assert_served_equal,
    chat_tokenizers, family_setup, images, noisy, port_arch)

TOL = dict(atol=1e-5, rtol=1e-5)
TEXT = dict(vocab_size=MODEL_VOCAB, hidden_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, intermediate_size=128,
            rope_theta=1e6, qkv_bias=True, rms_eps=1e-6)


def _jarch(image_token_id=150, **vision):
    vit = dict(hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=64, image_size=56, patch_size=14)
    vit.update(vision)
    return JInternVL(vision=JViT(**vit), text=JLlama(**TEXT),
                     image_token_id=image_token_id, max_dynamic_tiles=4)


def _models(seed=0, **vision):
    jarch = _jarch(**vision)
    jparams = noisy(jinternvl.init_params(jax.random.PRNGKey(seed), jarch),
                    seed + 1)
    return jarch, jparams, port_arch(jarch), from_jax_params(jparams, "cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("hw", [(100, 150), (30, 200), (448, 448),
                                (500, 90), (61, 61), (33, 257)])
@pytest.mark.parametrize("tile,max_num", [(28, 12), (56, 6), (14, 4)])
def test_dynamic_tile_is_byte_equal_to_the_jax_tiling(hw, tile, max_num):
    im = images(sum(hw), [hw])[0]
    want = jtiling.dynamic_tile(im, tile_size=tile, max_num=max_num)
    got = tiling.dynamic_tile(im, tile_size=tile, max_num=max_num)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    for max_tiles in (max_num + 1, 2):
        for g, w in zip(tiling.pad_tiles(got, max_tiles),
                        jtiling.pad_tiles(want, max_tiles)):
            assert g.tobytes() == w.tobytes()


def test_grids_equal_the_jax_ones():
    for lo, hi in ((1, 12), (2, 6), (1, 1)):
        grids = tiling.candidate_grids(lo, hi)
        assert grids == jtiling.candidate_grids(lo, hi)
        for w, h in ((640, 480), (100, 1000), (448, 448), (50, 60)):
            assert tiling.closest_aspect_ratio(w / h, grids, w, h, 448) == \
                jtiling.closest_aspect_ratio(w / h, grids, w, h, 448)


@pytest.mark.parametrize("vision", [
    dict(), dict(use_qk_norm=True), dict(norm_type="rms_norm")])
def test_image_features_match_jax(vision):
    jarch, jparams, arch, params = _models(2, **vision)
    px = np.random.default_rng(3).normal(size=(3, 56, 56, 3)).astype(
        np.float32)
    want = jinternvl.vision_apply(jparams["vision"], jnp.asarray(px),
                                  jarch.vision)
    got = internvl.vision_apply(params["vision"], _t(px), arch.vision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    feats = np.asarray(want)[:, 1:].reshape(3, 4, 4, 32)
    np.testing.assert_array_equal(
        internvl.pixel_shuffle(_t(feats), 0.5).numpy(),
        np.asarray(jinternvl.pixel_shuffle(jnp.asarray(feats), 0.5)))
    want = jinternvl.image_features(jparams, jnp.asarray(px), jarch)
    got = internvl.image_features(params, _t(px), arch)
    assert got.shape == (3, arch.num_image_tokens, TEXT["hidden_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_chunks_give_the_whole_batch():
    from mllm_sparse_retrieval_tpu_torch.models import layers as L

    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.normal(size=(5, 9, 4, 8)).astype(np.float32))
               for _ in range(3))
    mask = _t(rng.uniform(size=(5, 1, 9, 9)) > 0.3) | torch.eye(9,
                                                                dtype=bool)
    whole = L.attention(q, k, v, mask)
    for chunk in (4 * 9 * 9 * 4, 2 * 4 * 9 * 9 * 4, 1):
        np.testing.assert_array_equal(
            L.attention_chunked(q, k, v, mask, chunk_bytes=chunk).numpy(),
            whole.numpy())
        np.testing.assert_array_equal(
            L.attention_chunked(q, k, v, mask[:1], chunk_bytes=chunk)
            .numpy(), L.attention(q, k, v, mask[:1]).numpy())


def _prompt_batch(arch, n_tiles):
    t = max(n_tiles) * arch.num_image_tokens + 8
    ids = np.zeros((len(n_tiles), t), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(n_tiles):
        row = [1, 5] + [arch.image_token_id] * (
            n * arch.num_image_tokens) + [7, 9]
        ids[i, :len(row)], mask[i, :len(row)] = row, 1
    return ids, mask


def test_encode_matches_jax_with_tiles_and_text():
    jarch, jparams, arch, params = _models(5)
    ims = images(6, SIZES[:3])
    tiles = [jtiling.dynamic_tile(im, 56, max_num=4) for im in ims]
    px = np.stack([jtiling.pad_tiles(t, 5)[0] for t in tiles])
    ids, mask = _prompt_batch(arch, [t.shape[0] for t in tiles])
    want = jinternvl.encode(jparams, jarch, jnp.asarray(ids),
                            jnp.asarray(mask), jnp.asarray(px))
    got = internvl.encode(params, arch, _t(ids).long(), _t(mask), _t(px))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # one tile an image ([B, S, S, 3]) and text only
    ids1, mask1 = _prompt_batch(arch, [1, 1, 1])
    for vision in (px[:, 0], None):
        want = japi.encode_any(jparams, jarch, jnp.asarray(ids1),
                               jnp.asarray(mask1),
                               None if vision is None
                               else jnp.asarray(vision))
        got = api.encode_any(params, arch, _t(ids1).long(), _t(mask1),
                             None if vision is None else _t(vision))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_image_input_spec_matches_jax():
    jarch = _jarch()
    arch = port_arch(jarch)
    spec, jspec = api.image_input_spec(arch), japi.image_input_spec(jarch)
    assert (spec.variable, spec.max_image_tokens, spec.image_size,
            spec.needs_mrope) == (jspec.variable, jspec.max_image_tokens,
                                  jspec.image_size, jspec.needs_mrope)
    ims = images(7, SIZES)
    items = [spec.preprocess_example(im) for im in ims]
    jitems = [jspec.preprocess_example(im) for im in ims]
    for (a, n), (b, m) in zip(items, jitems):
        assert n == m and a.tobytes() == np.asarray(b).tobytes()
    assert spec.batch_vision([a for a, _ in items]).tobytes() == \
        np.asarray(jspec.batch_vision([b for b, _ in jitems])).tobytes()
    assert api.mrope_ids_for_batch(arch, None, None) is None


def _hf_state_dict(arch, seed, layout, qk_norm=False):
    """An HF InternVLForConditionalGeneration-shaped state dict of seeded
    numpy arrays: transformers >= 4.52's ``state_dict()`` layout
    (``model.vision_tower.*``, ``model.language_model.*``, ``lm_head``) or
    the legacy one (``vision_tower.*``, ``language_model.model.*``,
    ``language_model.lm_head``)."""
    rng = np.random.default_rng(seed)
    v, t = arch.vision, arch.text
    h, p, dh = v.hidden_size, v.patch_size, t.head_dim
    new = layout == "new"
    vt = "model.vision_tower" if new else "vision_tower"
    mp = "model.multi_modal_projector" if new else "multi_modal_projector"
    lm = "model.language_model" if new else "language_model.model"
    sd = {}

    def put(name, *shape):
        sd[name] = rng.normal(size=shape).astype(np.float32)

    def linear(name, fan_in, fan_out, bias=True):
        put(f"{name}.weight", fan_out, fan_in)
        if bias:
            put(f"{name}.bias", fan_out)

    put(f"{vt}.embeddings.patch_embeddings.projection.weight", h, 3, p, p)
    put(f"{vt}.embeddings.patch_embeddings.projection.bias", h)
    put(f"{vt}.embeddings.cls_token", 1, 1, h)
    put(f"{vt}.embeddings.position_embeddings", 1, v.num_patches + 1, h)
    for i in range(v.num_layers):
        b = f"{vt}.encoder.layer.{i}"
        for n in ("layernorm_before", "layernorm_after"):
            put(f"{b}.{n}.weight", h)
            put(f"{b}.{n}.bias", h)
        for n in ("q_proj", "k_proj", "v_proj", "projection_layer"):
            linear(f"{b}.attention.{n}", h, h)
        linear(f"{b}.mlp.fc1", h, v.intermediate_size)
        linear(f"{b}.mlp.fc2", v.intermediate_size, h)
        put(f"{b}.lambda_1", h)
        put(f"{b}.lambda_2", h)
        if qk_norm:
            put(f"{b}.attention.q_norm.weight", h)
            put(f"{b}.attention.k_norm.weight", h)
    shuffle = 4 * h
    put(f"{mp}.layer_norm.weight", shuffle)
    put(f"{mp}.layer_norm.bias", shuffle)
    linear(f"{mp}.linear_1", shuffle, t.hidden_size)
    linear(f"{mp}.linear_2", t.hidden_size, t.hidden_size)
    put(f"{lm}.embed_tokens.weight", t.vocab_size, t.hidden_size)
    put(f"{lm}.norm.weight", t.hidden_size)
    for i in range(t.num_layers):
        b = f"{lm}.layers.{i}"
        put(f"{b}.input_layernorm.weight", t.hidden_size)
        put(f"{b}.post_attention_layernorm.weight", t.hidden_size)
        linear(f"{b}.self_attn.q_proj", t.hidden_size, t.num_heads * dh)
        linear(f"{b}.self_attn.k_proj", t.hidden_size, t.num_kv_heads * dh)
        linear(f"{b}.self_attn.v_proj", t.hidden_size, t.num_kv_heads * dh)
        linear(f"{b}.self_attn.o_proj", t.num_heads * dh, t.hidden_size,
               bias=False)
        linear(f"{b}.mlp.gate_proj", t.hidden_size, t.intermediate_size,
               bias=False)
        linear(f"{b}.mlp.up_proj", t.hidden_size, t.intermediate_size,
               bias=False)
        linear(f"{b}.mlp.down_proj", t.intermediate_size, t.hidden_size,
               bias=False)
    head = "lm_head" if new else "language_model.lm_head"
    linear(head, t.hidden_size, t.vocab_size, bias=False)
    return sd


def _torch_sd(sd):
    """The dict as the JAX converter takes it (torch tensors, as an HF
    model's ``state_dict()`` gives them)."""
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _assert_trees_byte_equal(got, want):
    gl, gt = jax.tree_util.tree_flatten(got)
    wl, wt = jax.tree_util.tree_flatten(want)
    assert gt == wt
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("qk_norm", [False, True])
def test_state_dict_map_is_byte_equal_to_the_jax_converter(qk_norm):
    arch = _jarch(use_qk_norm=qk_norm)
    sd = _hf_state_dict(arch, 8, "new", qk_norm)
    args = (arch.vision.num_layers, arch.text.num_layers)
    want = jconvert.convert_internvl_state_dict(_torch_sd(sd), *args,
                                                use_qk_norm=qk_norm)
    got = convert.convert_internvl_state_dict(sd, *args, use_qk_norm=qk_norm)
    _assert_trees_byte_equal(got, want)
    # the legacy key layout maps to the same tree
    legacy = _hf_state_dict(arch, 8, "legacy", qk_norm)
    _assert_trees_byte_equal(
        convert.convert_internvl_state_dict(legacy, *args,
                                            use_qk_norm=qk_norm), want)


def _hf_config(arch):
    v, t = arch.vision, arch.text
    return {
        "model_type": "internvl", "image_token_id": arch.image_token_id,
        "downsample_ratio": 0.5,
        "vision_config": {
            "hidden_size": v.hidden_size, "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads,
            "intermediate_size": v.intermediate_size,
            "image_size": [v.image_size, v.image_size],
            "patch_size": [v.patch_size, v.patch_size],
            "norm_type": v.norm_type, "use_qk_norm": v.use_qk_norm},
        "text_config": {
            "model_type": "qwen2", "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size,
            "num_hidden_layers": t.num_layers,
            "num_attention_heads": t.num_heads,
            "num_key_value_heads": t.num_kv_heads,
            "intermediate_size": t.intermediate_size,
            "max_position_embeddings": 4096, "rope_theta": t.rope_theta,
            "rms_norm_eps": t.rms_eps, "tie_word_embeddings": False}}


def test_checkpoint_converts_loads_and_builds(tmp_path):
    from safetensors.numpy import save_file

    arch = _jarch()
    cfg = _hf_config(arch)
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps(cfg))
    sd = _hf_state_dict(arch, 9, "new")
    save_file(sd, str(hf / "model.safetensors"))
    out = tmp_path / "out"
    convert.convert_hf_dir(str(hf), str(out))
    jarch_cfg = jconvert.arch_from_hf_config(cfg)
    manifest = json.loads((out / "arch.json").read_text())
    assert manifest == json.loads(json.dumps(
        jconvert.arch_to_manifest(jarch_cfg)))
    params, tok, loaded = convert.load_converted(str(out), device="cpu")
    assert tok is None
    assert dataclasses.asdict(loaded) == dataclasses.asdict(jarch_cfg)
    want = jconvert.convert_internvl_state_dict(
        _torch_sd(sd), arch.vision.num_layers, arch.text.num_layers)
    _assert_trees_byte_equal(
        jax.tree_util.tree_map(lambda x: x.numpy(), params), want)
    built, barch, btok, tmpl = registry.build_model(
        ModelConfig(family=ModelFamily.INTERNVL2_5, dtype="float32",
                    checkpoint_path=str(out)), device="cpu")
    assert barch == loaded and btok is None
    assert tmpl is templates.INTERNVL2_5
    assert built["vision"]["blocks"][0]["q"]["b"].dtype == torch.float32


@pytest.fixture(scope="module")
def served():
    jtok, _ = chat_tokenizers()
    jarch = _jarch(image_token_id=jtok.special_ids["<IMG_CONTEXT>"])
    jparams = noisy(jinternvl.init_params(jax.random.PRNGKey(11), jarch), 12)
    return jarch, jparams


def test_served_slice_matches_jax(served):
    jarch, jparams = served
    assert_served_equal(family_setup(jarch, jparams, "INTERNVL2_5"))


def test_encode_examples_matches_jax(served):
    jarch, jparams = served
    assert_encode_examples_equal(jarch, jparams, "INTERNVL2_5")
