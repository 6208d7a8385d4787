"""PyTorch port, Qwen2.5-VL (the windowed ViT, native-resolution
preprocessing, M-RoPE) against the JAX package on seeded numpy inputs and
the same weights (a tiny JAX tree with seeded noise on every leaf, carried
across by ``convert_jax``).

Tolerances: the host tables are bit-equal (``smart_resize``,
``preprocess_native``, which resizes without Pillow here and with it in the
JAX package, ``patchify``, ``vision_layout``, ``_uniform_window_layout``,
``mrope_position_ids``, the spec's ``mrope_from_batch``); the state-dict map
gives byte-equal trees; f32 model outputs (``vision_apply``,
``vision_apply_native`` on a batch of different grids, ``encode``'s sparse
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

from mllm_sparse_retrieval_tpu.models import api as japi
from mllm_sparse_retrieval_tpu.models import convert as jconvert
from mllm_sparse_retrieval_tpu.models import qwen_vl as jqwen
from mllm_sparse_retrieval_tpu.models.llama import LlamaConfig as JLlama
from mllm_sparse_retrieval_tpu.models.qwen_vl import (
    QwenViTConfig as JViT, QwenVLConfig as JQwen)
from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, ModelFamily
from mllm_sparse_retrieval_tpu_torch.models import api, convert, qwen_vl
from mllm_sparse_retrieval_tpu_torch.models import registry, templates
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from tests.test_torch_chat_templates import (
    MODEL_VOCAB, SIZES, assert_encode_examples_equal, assert_served_equal,
    chat_tokenizers, family_setup, images, noisy, port_arch)
from tests.test_torch_internvl import _assert_trees_byte_equal, _torch_sd

TOL = dict(atol=1e-5, rtol=1e-5)
FACTOR = 28
GRIDS = [(8, 12), (16, 4), (4, 4)]          # patches per side, per image


def _jarch(image_token_id=150, native=True, max_units=24, **kw):
    return JQwen(
        vision=JViT(hidden_size=64, depth=3, num_heads=4,
                    intermediate_size=128, out_hidden_size=64,
                    window_size=56, fullatt_block_indexes=(1,)),
        text=JLlama(vocab_size=MODEL_VOCAB, hidden_size=64, num_layers=2,
                    num_heads=4, num_kv_heads=2, intermediate_size=128,
                    rope_theta=1e6, qkv_bias=True, rms_eps=1e-6,
                    mrope_section=(4, 2, 2), **kw),
        image_token_id=image_token_id, vision_start_token_id=151,
        grid_h=8, grid_w=8, native_resolution=native,
        min_pixels=4 * FACTOR * FACTOR,
        max_pixels=max_units * FACTOR * FACTOR)


def _models(seed=0, **kw):
    jarch = _jarch(**kw)
    jparams = noisy(jqwen.init_params(jax.random.PRNGKey(seed), jarch),
                    seed + 1)
    return jarch, jparams, port_arch(jarch), from_jax_params(jparams, "cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_smart_resize_equals_the_jax_one():
    rng = np.random.default_rng(0)
    for h, w in rng.integers(20, 3000, size=(200, 2)).tolist() + [
            (28, 28), (10, 1900), (4000, 3000)]:
        for lo, hi in ((4 * 784, 768 * 784), (784, 16 * 784)):
            assert qwen_vl.smart_resize(h, w, FACTOR, lo, hi) == \
                jqwen.smart_resize(h, w, FACTOR, lo, hi)
    with pytest.raises(ValueError, match="aspect"):
        qwen_vl.smart_resize(10, 2500)


@pytest.mark.parametrize("hw", [(100, 150), (200, 60), (56, 56), (30, 700),
                                (333, 41), (17, 19)])
def test_preprocess_native_is_bit_equal_without_pillow(hw):
    jarch = _jarch()
    arch = port_arch(jarch)
    im = images(sum(hw), [hw])[0]
    got, n = qwen_vl.preprocess_native(im, arch)
    want, m = jqwen.preprocess_native(im, jarch)
    assert n == m and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k


def test_layout_tables_are_bit_equal():
    v = _jarch().vision
    for gh, gw in GRIDS + [(8, 8)]:
        args = (gh, gw, v.spatial_merge_size, v.window_size, v.patch_size,
                v.head_dim, v.rope_theta)
        got, want = qwen_vl.vision_layout(*args), jqwen.vision_layout(*args)
        assert set(got) == set(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
        got = qwen_vl._uniform_window_layout(*args, 48)
        want = jqwen._uniform_window_layout(*args, 48)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
    im = np.random.default_rng(1).normal(size=(112, 56, 3)).astype(
        np.float32)
    assert qwen_vl.patchify(im, v).tobytes() == \
        jqwen.patchify(im, v).tobytes()


def _prompts(n_units, image_token_id, lead=3, tail=4):
    t = max(n_units) + lead + tail + 5
    ids = np.zeros((len(n_units), t), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(n_units):
        row = list(range(1, lead + 1)) + [image_token_id] * n + \
            list(range(10, 10 + tail + i))
        ids[i, :len(row)], mask[i, :len(row)] = row, 1
    return ids, mask


def test_mrope_position_ids_are_bit_equal():
    ids, mask = _prompts([24, 4, 16], 150)
    grids = np.array([[1, 8, 12], [1, 4, 4], [1, 16, 4]])
    for thw in (grids, (1, 8, 8)):
        got = qwen_vl.mrope_position_ids(ids, mask, 150, thw, 2)
        want = jqwen.mrope_position_ids(ids, mask, 150, thw, 2)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # text only: the three components advance together
    txt = qwen_vl.mrope_position_ids(ids, mask, 999, (1, 8, 8), 2)
    assert (txt[0] == txt[1]).all() and (txt[1] == txt[2]).all()


def test_fixed_grid_vision_matches_jax():
    jarch, jparams, arch, params = _models(2, native=False)
    rng = np.random.default_rng(3)
    patches = np.stack([jqwen.patchify(rng.normal(size=(112, 112, 3))
                                       .astype(np.float32), jarch.vision)
                        for _ in range(2)])
    want = jqwen.vision_apply(jparams["vision"], jnp.asarray(patches),
                              jarch.vision, 8, 8)
    got = qwen_vl.vision_apply(params["vision"], _t(patches), arch.vision,
                               8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _native_batch(jarch, seed):
    """A batch of three images of different grids, as items of each
    package (the patches seeded, the layout from each package)."""
    rng = np.random.default_rng(seed)
    pd = jarch.vision.patch_dim
    arch = port_arch(jarch)
    items, jitems = [], []
    for gh, gw in GRIDS:
        p = rng.normal(size=(gh * gw, pd)).astype(np.float32)
        items.append(qwen_vl.native_item_from_patches(p, gh, gw, arch))
        jitems.append(jqwen.native_item_from_patches(p, gh, gw, jarch))
    for (a, n), (b, m) in zip(items, jitems):
        assert n == m
        for k in b:
            assert a[k].tobytes() == b[k].tobytes(), k
    return (qwen_vl.batch_native([i for i, _ in items]),
            [n for _, n in items])


def test_native_vision_matches_jax_on_different_grids():
    jarch, jparams, arch, params = _models(4)
    vb, _ = _native_batch(jarch, 5)
    want = jqwen.vision_apply_native(
        jparams["vision"], jax.tree_util.tree_map(jnp.asarray, vb),
        jarch.vision)
    got = qwen_vl.vision_apply_native(
        params["vision"], {k: _t(v) for k, v in vb.items()}, arch.vision)
    assert got.shape == (3, jarch.padded_window_units, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_matches_jax_native_fixed_and_text():
    jarch, jparams, arch, params = _models(6)
    vb, n_units = _native_batch(jarch, 7)
    ids, mask = _prompts(n_units, 150)
    thw = np.concatenate([np.ones((3, 1), np.int64), vb["grid_hw"]], 1)
    pos = jqwen.mrope_position_ids(ids, mask, 150, thw, 2)
    want = jqwen.encode(jparams, jarch, jnp.asarray(ids), jnp.asarray(mask),
                        jax.tree_util.tree_map(jnp.asarray, vb),
                        jnp.asarray(pos))
    got = api.encode_any(params, arch, _t(ids).long(), _t(mask),
                         {k: _t(v) for k, v in vb.items()},
                         position_ids=_t(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # fixed grid with its shared M-RoPE ids; text only with 1-D positions
    farch, jfarch = dataclasses.replace(arch, native_resolution=False), \
        dataclasses.replace(jarch, native_resolution=False)
    ids, mask = _prompts([16, 16], 150)
    pos = api.mrope_ids_for_batch(farch, ids, mask)
    np.testing.assert_array_equal(pos,
                                  japi.mrope_ids_for_batch(jfarch, ids, mask))
    patches = np.random.default_rng(8).normal(
        size=(2, 64, jarch.vision.patch_dim)).astype(np.float32)
    for vision, p in ((patches, pos), (None, None)):
        want = japi.encode_any(jparams, jfarch, jnp.asarray(ids),
                               jnp.asarray(mask),
                               None if vision is None
                               else jnp.asarray(vision),
                               position_ids=None if p is None
                               else jnp.asarray(p))
        got = api.encode_any(params, farch, _t(ids).long(), _t(mask),
                             None if vision is None else _t(vision),
                             position_ids=None if p is None else _t(p))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("native", [True, False])
def test_image_input_spec_matches_jax(native):
    jarch = _jarch(native=native)
    arch = port_arch(jarch)
    spec, jspec = api.image_input_spec(arch), japi.image_input_spec(jarch)
    assert (spec.variable, spec.max_image_tokens, spec.image_size,
            spec.needs_mrope, spec.num_image_tokens) == (
                jspec.variable, jspec.max_image_tokens, jspec.image_size,
                jspec.needs_mrope, jspec.num_image_tokens)
    if not native:
        im = np.random.default_rng(9).normal(size=(112, 112, 3)).astype(
            np.float32)
        assert spec.preprocess(im).tobytes() == jspec.preprocess(im).tobytes()
        return
    ims = images(10, SIZES)
    items = [spec.preprocess_example(im) for im in ims]
    jitems = [jspec.preprocess_example(im) for im in ims]
    vb = spec.batch_vision([i for i, _ in items])
    jvb = jspec.batch_vision([i for i, _ in jitems])
    for k in jvb:
        assert vb[k].tobytes() == np.asarray(jvb[k]).tobytes(), k
    ids, mask = _prompts([n for _, n in items], 150)
    assert spec.mrope_from_batch(ids, mask, vb).tobytes() == \
        jspec.mrope_from_batch(ids, mask, jvb).tobytes()


def _hf_state_dict(arch, seed, layout, tied=False):
    """An HF Qwen2_5_VLForConditionalGeneration-shaped state dict of seeded
    numpy arrays: transformers >= 4.52's ``state_dict()`` layout
    (``model.visual.*``, ``model.language_model.*``, ``lm_head``) or the
    hub's shards (``visual.*``, ``model.*``); a tied head is listed as
    ``state_dict()`` lists it, or left out as the hub's shards leave it
    out (``tied``)."""
    rng = np.random.default_rng(seed)
    v, t = arch.vision, arch.text
    h, dh = v.hidden_size, t.head_dim
    new = layout == "new"
    vis = "model.visual" if new else "visual"
    lm = "model.language_model" if new else "model"
    sd = {}

    def put(name, *shape):
        sd[name] = rng.normal(size=shape).astype(np.float32)

    def linear(name, fan_in, fan_out, bias=True):
        put(f"{name}.weight", fan_out, fan_in)
        if bias:
            put(f"{name}.bias", fan_out)

    put(f"{vis}.patch_embed.proj.weight", h, v.in_channels,
        v.temporal_patch_size, v.patch_size, v.patch_size)
    for i in range(v.depth):
        b = f"{vis}.blocks.{i}"
        put(f"{b}.norm1.weight", h)
        put(f"{b}.norm2.weight", h)
        linear(f"{b}.attn.qkv", h, 3 * h)
        linear(f"{b}.attn.proj", h, h)
        linear(f"{b}.mlp.gate_proj", h, v.intermediate_size)
        linear(f"{b}.mlp.up_proj", h, v.intermediate_size)
        linear(f"{b}.mlp.down_proj", v.intermediate_size, h)
    put(f"{vis}.merger.ln_q.weight", h)
    linear(f"{vis}.merger.mlp.0", 4 * h, 4 * h)
    linear(f"{vis}.merger.mlp.2", 4 * h, v.out_hidden_size)
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
        for n, a, c in (("gate_proj", t.hidden_size, t.intermediate_size),
                        ("up_proj", t.hidden_size, t.intermediate_size),
                        ("down_proj", t.intermediate_size, t.hidden_size)):
            linear(f"{b}.mlp.{n}", a, c, bias=False)
    if not tied:
        linear("lm_head", t.hidden_size, t.vocab_size, bias=False)
    return sd


def test_state_dict_map_is_byte_equal_to_the_jax_converter():
    arch = _jarch()
    args = (arch.vision.depth, arch.text.num_layers)
    sd = _hf_state_dict(arch, 11, "new")
    want = jconvert.convert_qwen25vl_state_dict(_torch_sd(sd), *args)
    _assert_trees_byte_equal(convert.convert_qwen25vl_state_dict(sd, *args),
                             want)
    _assert_trees_byte_equal(convert.convert_qwen25vl_state_dict(
        _hf_state_dict(arch, 11, "hub"), *args), want)
    # tied: no head in the tree unless the dict lists one
    tied = _hf_state_dict(arch, 12, "new", tied=True)
    got = convert.convert_qwen25vl_state_dict(tied, *args)
    assert "lm_head" not in got["text"]
    _assert_trees_byte_equal(got, jconvert.convert_qwen25vl_state_dict(
        _torch_sd(tied), *args))


def _hf_config(arch, inline_text=False):
    v, t = arch.vision, arch.text
    text = {"model_type": "qwen2_5_vl_text", "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size, "num_hidden_layers": t.num_layers,
            "num_attention_heads": t.num_heads,
            "num_key_value_heads": t.num_kv_heads,
            "intermediate_size": t.intermediate_size,
            "max_position_embeddings": 512, "rope_theta": t.rope_theta,
            "rms_norm_eps": t.rms_eps, "tie_word_embeddings": True,
            "rope_scaling": {"type": "mrope",
                             "mrope_section": list(t.mrope_section)}}
    cfg = {"model_type": "qwen2_5_vl", "image_token_id": 150,
           "vision_start_token_id": 151,
           "vision_config": {
               "hidden_size": v.hidden_size, "depth": v.depth,
               "num_heads": v.num_heads,
               "intermediate_size": v.intermediate_size,
               "out_hidden_size": v.out_hidden_size,
               "patch_size": v.patch_size, "window_size": v.window_size,
               "fullatt_block_indexes": list(v.fullatt_block_indexes)}}
    if inline_text:
        cfg.update({k: x for k, x in text.items() if k != "model_type"})
    else:
        cfg["text_config"] = text
    return cfg


@pytest.mark.parametrize("inline_text", [False, True])
def test_arch_from_hf_config_equals_the_jax_one(inline_text):
    cfg = _hf_config(_jarch(), inline_text)
    got, want = convert.arch_from_hf_config(cfg), \
        jconvert.arch_from_hf_config(cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.text.mrope_section == (4, 2, 2) and got.native_resolution


def test_tied_hub_checkpoint_converts_loads_and_builds(tmp_path):
    from safetensors.numpy import save_file

    arch = _jarch()
    cfg = _hf_config(arch)
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps(cfg))
    sd = _hf_state_dict(arch, 13, "hub", tied=True)
    half = len(sd) // 2
    names = sorted(sd)
    shards = {"model-1.safetensors": names[:half],
              "model-2.safetensors": names[half:]}
    for file, keys in shards.items():
        save_file({k: sd[k] for k in keys}, str(hf / file))
    (hf / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    out = tmp_path / "out"
    convert.convert_hf_dir(str(hf), str(out))
    params, tok, loaded = convert.load_converted(str(out), device="cpu")
    assert tok is None
    assert dataclasses.asdict(loaded) == dataclasses.asdict(
        jconvert.arch_from_hf_config(cfg))
    # the JAX converter reads the >= 4.52 layout, where the tied head is
    # listed as state_dict() lists it: the embedding
    listed = {("model." + k if k.startswith("visual.") else
               k.replace("model.", "model.language_model.", 1)): x
              for k, x in sd.items()}
    listed["lm_head.weight"] = sd["model.embed_tokens.weight"]
    want = jconvert.convert_qwen25vl_state_dict(
        _torch_sd(listed), arch.vision.depth, arch.text.num_layers)
    _assert_trees_byte_equal(
        jax.tree_util.tree_map(lambda x: x.numpy(), params), want)
    _, barch, _, tmpl = registry.build_model(
        ModelConfig(family=ModelFamily.QWEN2_5_VL, dtype="float32",
                    checkpoint_path=str(out)), device="cpu")
    assert barch == loaded and tmpl is templates.QWEN2_5_VL


def test_tiny_qwen_family_builds_and_encodes():
    params, arch, tok, tmpl = registry.build_model(
        ModelConfig(family=ModelFamily.TINY_QWEN_DEBUG, dtype="float32"),
        captions=["a dog runs"], device="cpu")
    assert isinstance(arch, qwen_vl.QwenVLConfig) and tmpl is templates.TINY
    spec = api.image_input_spec(arch)
    px = spec.preprocess(np.zeros((spec.image_size, spec.image_size, 3),
                                  np.float32))
    ids, mask = tok.pad_batch([tok.encode(tmpl.expand_image(
        tmpl.image_prompt(), spec.num_image_tokens))])
    pos = api.mrope_ids_for_batch(arch, ids, mask)
    sparse, dense = api.encode_any(params, arch, _t(ids).long(), _t(mask),
                                   _t(px[None]), position_ids=_t(pos))
    assert sparse.shape == (1, arch.text.vocab_size)
    assert torch.isfinite(dense).all()


@pytest.fixture(scope="module")
def served():
    jtok, _ = chat_tokenizers()
    jarch = _jarch(image_token_id=jtok.special_ids["<|image_pad|>"],
                   max_units=16)
    jparams = noisy(jqwen.init_params(jax.random.PRNGKey(14), jarch), 15)
    return jarch, jparams


def test_served_slice_matches_jax(served):
    jarch, jparams = served
    assert_served_equal(family_setup(jarch, jparams, "QWEN2_5_VL"))


def test_encode_examples_matches_jax(served):
    jarch, jparams = served
    assert_encode_examples_equal(jarch, jparams, "QWEN2_5_VL")
