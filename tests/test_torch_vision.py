"""PyTorch port, vision path: the ViT, the projector, the image splice, anyres
preprocessing and ``mllm.encode`` with pixels, against the JAX package on
the same seeded inputs and on weights carried across with
``from_jax_params``; and the port's numpy bicubic resample against Pillow.

Tolerances (f32 on the CPU): ``atol=rtol=1e-5`` on ViT, projector, splice
and hidden-state outputs and dense reps, ``1e-4`` on sparse logits (XLA and
PyTorch sum matmuls in different orders, a few ulps per layer; the LM head
adds one decade). Anyres pixels, feature indices and token counts, and the
resample against Pillow: exact (bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import RepsLoc as JRepsLoc
from mllm_sparse_retrieval_tpu.models import anyres as JA
from mllm_sparse_retrieval_tpu.models import layers as JL
from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models import templates as jtemplates
from mllm_sparse_retrieval_tpu.models import vit as jvit
from mllm_sparse_retrieval_tpu.models.llama import LlamaConfig as JLlamaConfig
from mllm_sparse_retrieval_tpu.models.mllm import MLLMConfig as JMLLMConfig
from mllm_sparse_retrieval_tpu.models.registry import (
    get_family_spec as j_spec, tiny_debug_arch as j_tiny_arch)
from mllm_sparse_retrieval_tpu.models.vit import ViTConfig as JViTConfig
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, RepsLoc)
from mllm_sparse_retrieval_tpu_torch.models import anyres as A
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.models import mllm, templates, vit
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
from mllm_sparse_retrieval_tpu_torch.models.registry import (
    get_family_spec, tiny_debug_arch)
from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
SPARSE_TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(tiny_vocab_size=256, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4)
# a tiny LLaVA-NeXT: 28 px tiles of 14 px patches, three pinpoints
VIT = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
           num_heads=4, feature_layer=-2)
TEXT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, rope_theta=10000.0)
PINPOINTS = ((28, 56), (56, 28), (56, 56))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _anyres_archs():
    jarch = JMLLMConfig(vision=JViTConfig(**VIT), text=JLlamaConfig(**TEXT),
                        image_token_id=4, grid_pinpoints=PINPOINTS)
    arch = MLLMConfig(vision=ViTConfig(**VIT), text=LlamaConfig(**TEXT),
                      image_token_id=4, grid_pinpoints=PINPOINTS)
    return jarch, arch


def _ported(jparams):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


@pytest.fixture(scope="module")
def fixed_model():
    jarch = j_tiny_arch(JModelConfig(dtype="float32", **TINY))
    arch = tiny_debug_arch(ModelConfig(dtype="float32", **TINY))
    jparams = jmllm.init_params(jax.random.PRNGKey(0), jarch, jnp.float32)
    return jarch, arch, jparams, _ported(jparams)


@pytest.fixture(scope="module")
def anyres_model():
    jarch, arch = _anyres_archs()
    jparams = jmllm.init_params(jax.random.PRNGKey(1), jarch, jnp.float32)
    return jarch, arch, jparams, _ported(jparams)


@pytest.mark.parametrize("family", ["tiny_debug", "llava_next_llama3"])
def test_vision_configs_match_jax(family):
    spec = get_family_spec(ModelFamily(family), ModelConfig(**TINY))
    jspec = j_spec(JFamily(family), JModelConfig(**TINY))
    # the port builds only the CLIP tower; the JAX family uses its values
    jv = jspec.arch.vision
    assert (jv.act, jv.use_cls_token, jv.mlp_ratio) == ("quick_gelu", True, 4)
    assert spec.arch.vision.__dict__ == {
        k: getattr(jv, k) for k in spec.arch.vision.__dict__}
    assert spec.arch.vision.seq_len == jv.seq_len
    assert spec.arch.grid_pinpoints == jspec.arch.grid_pinpoints
    assert spec.arch.projector_hidden == jspec.arch.projector_hidden
    for f in ("anyres", "num_image_tokens", "patches_per_side"):
        assert getattr(spec.arch, f) == getattr(jspec.arch, f), f
    if spec.arch.anyres:
        assert spec.arch.max_tiles == jspec.arch.max_tiles == 5
        assert spec.arch.max_image_tokens == jspec.arch.max_image_tokens \
            == 576 + 48 * 49
    for one_word in (True, False):
        p = spec.template.image_prompt(one_word)
        assert p == jspec.template.image_prompt(one_word)
        assert spec.template.expand_image(p, 3) == \
            jspec.template.expand_image(p, 3)


def test_patchify_block_and_layernorm_match_jax(fixed_model):
    _, arch, jparams, params = fixed_model
    rng = np.random.default_rng(0)
    px = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        vit.patchify(_t(px), 16).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(px), 16)))
    x = rng.normal(size=(2, 17, 64)).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    np.testing.assert_allclose(
        L.layernorm(_t(x), {k: _t(v) for k, v in p.items()}).numpy(),
        np.asarray(JL.layernorm(jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in p.items()})),
        **TOL)
    blk, jblk = params["vision"]["blocks"][0], jparams["vision"]["blocks"][0]
    np.testing.assert_allclose(
        vit._block(_t(x), blk, 4).numpy(),
        np.asarray(jvit._block(jnp.asarray(x), jblk, 4, "quick_gelu")),
        **TOL)


@pytest.mark.parametrize("feature_layer", [-2, -1, 0])
def test_vit_apply_matches_jax(fixed_model, feature_layer):
    jarch, arch, jparams, params = fixed_model
    cfg = ViTConfig(**{**arch.vision.__dict__,
                       "feature_layer": feature_layer})
    jcfg = JViTConfig(**{**jarch.vision.__dict__,
                         "feature_layer": feature_layer})
    px = np.random.default_rng(1).normal(size=(3, 64, 64, 3)).astype(
        np.float32)
    got = vit.apply(params["vision"], _t(px), cfg)
    ref = jvit.apply(jparams["vision"], jnp.asarray(px), jcfg)
    assert got.shape == (3, 16, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_projector_and_splice_match_jax(fixed_model):
    _, _, jparams, params = fixed_model
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 16, 64)).astype(np.float32)
    np.testing.assert_allclose(
        mllm.project_image_features(params, _t(feats)).numpy(),
        np.asarray(jmllm.project_image_features(jparams,
                                                jnp.asarray(feats))), **TOL)
    tok = rng.normal(size=(2, 12, 64)).astype(np.float32)
    img = rng.normal(size=(2, 5, 64)).astype(np.float32)
    is_image = np.zeros((2, 12), bool)
    is_image[0, 2:7] = True
    is_image[1, [1, 3, 4]] = True
    got = mllm.splice_image_embeddings(_t(tok), _t(img), _t(is_image))
    ref = jmllm.splice_image_embeddings(jnp.asarray(tok), jnp.asarray(img),
                                        jnp.asarray(is_image))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _anyres_batch(arch, sizes, seed):
    rng = np.random.default_rng(seed)
    items, counts = [], []
    for s in sizes:
        a = A.preprocess_anyres(rng.uniform(size=s + (3,)).astype(np.float32),
                                arch.grid_pinpoints, arch.vision.image_size,
                                arch.patches_per_side, arch.max_tiles,
                                arch.max_image_tokens)
        items.append(a)
        counts.append(a.n_tokens)
    return (np.stack([a.pixels for a in items]),
            np.stack([a.feature_index for a in items]), counts)


def test_anyres_image_features_match_jax(anyres_model):
    jarch, arch, jparams, params = anyres_model
    px, idx, _ = _anyres_batch(arch, [(64, 64), (40, 120), (120, 40)], 3)
    got = mllm.anyres_image_features(params, arch, _t(px), _t(idx))
    ref = jmllm.anyres_image_features(jparams, jarch, jnp.asarray(px),
                                      jnp.asarray(idx))
    assert got.shape == (3, arch.max_image_tokens, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("size", [(375, 500), (500, 375), (640, 640),
                                  (300, 1000), (1000, 300), (720, 1280),
                                  (336, 336), (90, 70)])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_preprocess_anyres_equals_jax(size, dtype):
    rng = np.random.default_rng(sum(size))
    img = rng.uniform(size=size + (3,)).astype(np.float32)
    if dtype == "uint8":
        img = (img * 255).astype(np.uint8)
    args = (A.DEFAULT_GRID_PINPOINTS, 336, 24, 5, 576 + 48 * 49)
    got = A.preprocess_anyres(img, *args)
    ref = JA.preprocess_anyres(img, *args)
    np.testing.assert_array_equal(got.pixels, ref.pixels)
    np.testing.assert_array_equal(got.feature_index, ref.feature_index)
    assert (got.n_tokens, got.n_tiles) == (ref.n_tokens, ref.n_tiles)
    assert got.n_tokens == A.num_image_tokens(size, args[0], 336, 24)


def test_resize_bicubic_is_bit_equal_to_pil():
    rng = np.random.default_rng(7)
    cases = [((375, 500), (336, 336)), ((720, 1280), (378, 672)),
             ((300, 1000), (336, 1008)), ((64, 64), (336, 336)),
             ((17, 5), (3, 40)), ((640, 640), (672, 672)),
             ((100, 37), (100, 90)), ((41, 200), (7, 200)),
             ((1, 9), (5, 2))]
    for (h, w), (oh, ow) in cases:
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.BICUBIC))
        got = A.resize_bicubic(img, (oh, ow))
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)}")
    edges = np.zeros((24, 24, 3), np.uint8)
    edges[::2] = 255                          # overshoot both ways: clips
    np.testing.assert_array_equal(
        A.resize_bicubic(edges, (50, 31)),
        np.asarray(Image.fromarray(edges).resize((31, 50), Image.BICUBIC)))


def test_anyres_grid_arithmetic_matches_jax():
    pins = A.DEFAULT_GRID_PINPOINTS
    rng = np.random.default_rng(5)
    for _ in range(200):
        size = tuple(int(x) for x in rng.integers(20, 2000, size=2))
        assert A.select_best_resolution(size, pins) == \
            JA.select_best_resolution(size, pins)
        g = A.grid_shape(size, pins, 336)
        cur = (g[0] * 24, g[1] * 24)
        assert A.unpad_dims(size, cur) == JA.unpad_dims(size, cur)
        assert A.num_image_tokens(size, pins, 336, 24) == \
            JA.num_image_tokens(size, pins, 336, 24)
    assert A.max_tiles(pins, 336) == JA.max_tiles(pins, 336)
    assert A.max_image_tokens(pins, 336, 24) == \
        JA.max_image_tokens(pins, 336, 24)


@pytest.mark.parametrize("loc", ["before_pad", "after_pad"])
def test_mllm_encode_fixed_grid_pixels_match_jax(fixed_model, loc):
    jarch, arch, jparams, params = fixed_model
    rng = np.random.default_rng(4)
    n_img = arch.num_image_tokens
    ids = rng.integers(5, 256, size=(2, n_img + 12)).astype(np.int32)
    ids[:, 2:2 + n_img] = arch.image_token_id
    mask = np.ones_like(ids)
    mask[1, -4:] = 0
    px = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    sparse, dense = mllm.encode(params, arch, _t(ids).long(), _t(mask),
                                _t(px), RepsLoc(loc))
    jsparse, jdense = jmllm.encode(jparams, jarch, jnp.asarray(ids),
                                   jnp.asarray(mask), jnp.asarray(px),
                                   JRepsLoc(loc))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), **TOL)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse),
                               **SPARSE_TOL)


def test_mllm_encode_anyres_pixels_match_jax(anyres_model):
    jarch, arch, jparams, params = anyres_model
    px, idx, counts = _anyres_batch(arch, [(64, 64), (40, 120)], 6)
    tmpl = templates.TINY
    t = max(counts) + 8
    ids = np.zeros((2, t), np.int32)
    mask = np.zeros((2, t), np.int32)
    rng = np.random.default_rng(6)
    for i, n in enumerate(counts):
        row = [1, 20, 21] + [4] * n + list(rng.integers(5, 128, size=3))
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    vis = {"pixels": _t(px), "feature_index": _t(idx)}
    sparse, dense = mllm.encode(params, arch, _t(ids).long(), _t(mask),
                                pixel_values=vis)
    jsparse, jdense = jmllm.encode(
        jparams, jarch, jnp.asarray(ids), jnp.asarray(mask),
        {"pixels": jnp.asarray(px), "feature_index": jnp.asarray(idx)})
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), **TOL)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse),
                               **SPARSE_TOL)
    assert tmpl.expand_image("<image>", 2) == \
        jtemplates.TINY.expand_image("<image>", 2)


def test_from_jax_params_carries_the_vision_tree(anyres_model):
    _, arch, jparams, params = anyres_model
    assert set(params) == {"text", "vision", "projector", "image_newline"}
    for key in ("vision", "projector"):
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                        jparams[key])
        got = jax.tree_util.tree_map(lambda a: tuple(a.shape), params[key])
        assert got == shapes
    np.testing.assert_array_equal(params["image_newline"].numpy(),
                                  np.asarray(jparams["image_newline"]))
    gen = torch.Generator(device="cpu").manual_seed(0)
    drawn = mllm.init_params(arch, gen, device="cpu", dtype=torch.float32)
    same = jax.tree_util.tree_map(lambda a: tuple(a.shape), drawn)
    assert same == jax.tree_util.tree_map(lambda a: tuple(a.shape), params)


def test_unported_families_raise_with_the_roadmap_item():
    """Ported since: the calls that raised for Qwen2.5-VL and InternVL2.5
    give the JAX package's spec, and ``encode_any`` its reps."""
    from mllm_sparse_retrieval_tpu.models import api as japi
    from mllm_sparse_retrieval_tpu.models import registry as jregistry
    from mllm_sparse_retrieval_tpu_torch.models import api, registry

    for name in ("_qwen2_5_vl_7b_arch", "_internvl2_5_arch"):
        spec = api.image_input_spec(getattr(registry, name)())
        jspec = japi.image_input_spec(getattr(jregistry, name)())
        for field in ("num_image_tokens", "image_size", "needs_mrope",
                      "variable", "max_image_tokens"):
            assert getattr(spec, field) == getattr(jspec, field)
    jparams, jarch, jtok, _ = jregistry.build_model(
        JModelConfig(family=JFamily.TINY_QWEN_DEBUG, dtype="float32"),
        captions=["a dog runs"])
    arch = registry.get_family_spec(ModelFamily.TINY_QWEN_DEBUG).arch
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    ids, mask = jtok.pad_batch([jtok.encode("a dog runs")])
    want = japi.encode_any(jparams, jarch, jnp.asarray(ids),
                           jnp.asarray(mask))
    got = api.encode_any(params, arch, torch.from_numpy(ids).long(),
                         torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    spec = api.image_input_spec(tiny_debug_arch(ModelConfig(**TINY)))
    assert not spec.variable and spec.num_image_tokens == 16
    assert spec.image_size == 64
