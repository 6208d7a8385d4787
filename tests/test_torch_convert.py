"""PyTorch port: checkpoint conversion and loading (``models/convert.py``),
the LLaVA family registry and ``--checkpoint-path``, against the JAX
package on tiny random-init Hugging Face checkpoints saved here with
``save_pretrained``.

Tolerances: the converters' ``params.pkl`` and ``arch.json`` are compared
byte for byte, every widened tensor bit for bit, manifests, registry
entries and templates exactly. The port's encoders against JAX
``mllm.encode`` (f32 on the CPU): dense reps and sparse logits within
``atol=rtol=1e-5``.
"""

import dataclasses
import filecmp
import json
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.models import convert as jconvert
from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models import registry as jregistry
from mllm_sparse_retrieval_tpu.models import templates as jtemplates
from mllm_sparse_retrieval_tpu_torch.cli import encode as cli_encode
from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, ModelFamily
from mllm_sparse_retrieval_tpu_torch.models import anyres as A
from mllm_sparse_retrieval_tpu_torch.models import build_model
from mllm_sparse_retrieval_tpu_torch.models import convert
from mllm_sparse_retrieval_tpu_torch.models import mllm, registry, templates
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    HFTokenizerAdapter)

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB, IMG = 128, 120
PINPOINTS = [[28, 56], [56, 28], [56, 56]]
WORDS = ["a", "dog", "cat", "red", "bus", "man", "kite", "boat", "lake",
         "snow", "child", "bird", "grass", "city", "tree", "ball"]
# tiny HF checkpoints: LLaVA-1.5-style fixed grid, LLaVA-NeXT anyres at
# 4 query / 2 KV heads (G = 2, with a tokenizer) and 4 / 4 (G = 1, as
# LLaVA-1.6-Vicuna), and a fixed-grid model with tied embeddings
MODELS = {"fixed": ("llava", 2, False), "anyres_g2": ("llava_next", 2, False),
          "anyres_g1": ("llava_next", 4, False),
          "fixed_tied": ("llava", 2, True)}
LLAVA_FAMILIES = ["llava_next_llama3", "e5_v", "llava_1_5",
                  "llava_1_6_vicuna"]
# the tiny checkpoint each family loads (its HF model_type and head count)
FAMILY_MODEL = {"llava_next_llama3": "anyres_g2", "e5_v": "anyres_g2",
                "llava_1_5": "fixed", "llava_1_6_vicuna": "anyres_g1"}


def _save_tokenizer(path):
    """A word-level Llama-style tokenizer (``▁`` word pieces) over WORDS,
    ``<image>`` at id IMG."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0, "<pad>": 1}
    vocab.update({"▁" + w: i + 2 for i, w in enumerate(WORDS)})
    vocab["<image>"] = IMG
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Metaspace()
    PreTrainedTokenizerFast(
        tokenizer_object=tk, unk_token="<unk>", pad_token="<pad>",
        additional_special_tokens=["<image>"]).save_pretrained(str(path))


def _hf_model(kind, kv_heads, tied):
    from transformers import (CLIPVisionConfig, LlamaConfig, LlavaConfig,
                              LlavaForConditionalGeneration, LlavaNextConfig,
                              LlavaNextForConditionalGeneration)

    vision = CLIPVisionConfig(
        hidden_size=32, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, image_size=28, patch_size=14,
        projection_dim=32)
    text = LlamaConfig(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=tied)
    common = dict(vision_config=vision, text_config=text,
                  image_token_index=IMG, vision_feature_layer=-2,
                  projector_hidden_act="gelu", tie_word_embeddings=tied)
    torch.manual_seed(kv_heads + 10 * tied)
    if kind == "llava":
        return LlavaForConditionalGeneration(LlavaConfig(**common)).eval()
    return LlavaNextForConditionalGeneration(LlavaNextConfig(
        image_grid_pinpoints=PINPOINTS, **common)).eval()


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """name -> (HF directory, the model's state dict)."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for name, (kind, kv, tied) in MODELS.items():
        model = _hf_model(kind, kv, tied)
        model.save_pretrained(str(root / name))
        if name == "anyres_g2":
            _save_tokenizer(root / name)
        out[name] = (root / name, model.state_dict())
    return out


@pytest.fixture(scope="module")
def converted(hf, tmp_path_factory):
    """name -> (the JAX converter's output dir, the port's)."""
    root = tmp_path_factory.mktemp("converted")
    out = {}
    for name, (path, _) in hf.items():
        jconvert.convert_hf_dir(str(path), str(root / f"{name}_jax"))
        convert.convert_hf_dir(str(path), str(root / f"{name}_port"))
        out[name] = (root / f"{name}_jax", root / f"{name}_port")
    return out


def _pickled(path):
    with open(path / "params.pkl", "rb") as f:
        return pickle.load(f)


def _assert_trees_bit_equal(got, want):
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", list(MODELS))
def test_convert_hf_dir_is_byte_equal_to_the_jax_converter(converted, name,
                                                          tmp_path):
    jdir, pdir = converted[name]
    for f in ("params.pkl", "arch.json"):
        assert filecmp.cmp(jdir / f, pdir / f, shallow=False), f
    params = _pickled(pdir)
    # the port's pickler keeps no array data in its memo once written
    with open(tmp_path / "again.pkl", "wb") as f:
        pickler = convert._TreePickler(f, protocol=4)
        pickler.dump(params)
    assert filecmp.cmp(tmp_path / "again.pkl", pdir / "params.pkl",
                       shallow=False)
    held = [o for _, o in pickler.memo.values() if convert._large(o) or (
        isinstance(o, tuple) and any(map(convert._large, o)))]
    assert held == []
    assert ("image_newline" in params) == name.startswith("anyres")
    assert "lm_head" in params["text"]     # tied: aliased, as state_dict()
    if name == "anyres_g2":
        assert (pdir / "tokenizer.json").exists()


def _write(path, tensors, shards=1):
    """An HF checkpoint dir of ``tensors`` in ``shards`` safetensors files
    (with ``model.safetensors.index.json`` when more than one)."""
    path.mkdir()
    names = list(tensors)
    if shards == 1:
        safetensors_torch.save_file(tensors, str(path / "model.safetensors"))
        return
    weight_map = {}
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[s::shards]}
        safetensors_torch.save_file(part, str(path / fname))
        weight_map.update({n: fname for n in part})
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": 0}, "weight_map": weight_map}))


def _new_layout(key):
    """The hub's legacy key -> transformers >= 4.52's state_dict key."""
    if key.startswith("language_model.model."):
        return "model.language_model." + key[len("language_model.model."):]
    if key.startswith("language_model.lm_head"):
        return key[len("language_model."):]
    return "model." + key


@pytest.mark.parametrize("variant", ["new_layout", "sharded", "bf16",
                                     "f16", "bf16_sharded_new_layout"])
def test_layouts_dtypes_and_shards_widen_as_torch(hf, converted, tmp_path,
                                                  variant):
    path, sd = hf["anyres_g2"]
    with open(path / "config.json") as f:
        config = f.read()
    legacy = safetensors_torch.load_file(str(path / "model.safetensors"))
    dtype = (torch.bfloat16 if "bf16" in variant else
             torch.float16 if "f16" in variant else torch.float32)
    tensors = {(_new_layout(k) if "new_layout" in variant else k):
               v.to(dtype).contiguous() for k, v in legacy.items()}
    _write(tmp_path / "hf", tensors, shards=3 if "sharded" in variant else 1)
    (tmp_path / "hf" / "config.json").write_text(config)
    convert.convert_hf_dir(str(tmp_path / "hf"), str(tmp_path / "out"))
    # the JAX converter's mapping of the same tensors, widened by torch
    want = jconvert.convert_llava_state_dict(
        {k: v.to(dtype) for k, v in sd.items()}, 2, 2, 14)
    _assert_trees_bit_equal(_pickled(tmp_path / "out"), want)
    if dtype == torch.float32:
        assert filecmp.cmp(tmp_path / "out" / "params.pkl",
                           converted["anyres_g2"][0] / "params.pkl",
                           shallow=False)


SPECIALS = [0.0, -0.0, 1.0, -2.5, float("inf"), float("-inf"), 65504.0,
            6.0e-8, 1.0e-40, 3.0e38, float("nan")]


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                   "float64", "int32"])
def test_safetensors_reader_widens_bit_for_bit_or_raises(tmp_path, dtype):
    tdtype = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.normal(scale=3.0, size=61), SPECIALS]).astype(np.float64))
    tensors = {"w": x.to(tdtype).reshape(8, 9),
               "s": x[:1].to(tdtype)[0].clone(),
               "e": torch.zeros((0, 3), dtype=tdtype)}
    _write(tmp_path / "hf", tensors)
    sd = convert.SafetensorsStateDict(str(tmp_path / "hf"))
    assert set(sd) == set(tensors) and len(sd) == 3
    if dtype in ("float64", "int32"):
        with pytest.raises(ValueError, match="is not read"):
            sd["w"]
        return
    for key, t in tensors.items():
        got, want = sd[key], t.float().numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), key


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_params_pkl_loads_across_packages(converted, direction):
    jdir, pdir = converted["anyres_g2"]
    if direction == "jax_to_port":
        params, tok, arch = convert.load_converted(
            str(jdir), None, torch.float32, device="cpu")
        got = jax.tree_util.tree_map(lambda t: t.numpy(), params)
        manifest = json.loads((jdir / "arch.json").read_text())
        assert json.loads(json.dumps(dataclasses.asdict(arch))) == \
            manifest["config"]
        assert isinstance(tok, HFTokenizerAdapter)
        assert tok.encode("a dog", add_special_tokens=False) == [2, 3]
        assert tok.encode("<image>", add_special_tokens=False) == [IMG]
        assert all(t.is_contiguous() for t in jax.tree_util.tree_leaves(
            params))
        want = _pickled(jdir)
    else:
        params, tok, arch = jconvert.load_converted(str(pdir), None)
        got = jax.tree_util.tree_map(np.asarray, params)
        want = _pickled(pdir)
        assert tok is not None
    _assert_trees_bit_equal(got, want)


def _text_batch(rng):
    ids = rng.integers(2, 18, size=(2, 11)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, -3:] = 0
    return ids, mask, None


def _image_batch(arch, rng):
    if arch.anyres:
        items = [A.preprocess_anyres(
            rng.uniform(size=s + (3,)).astype(np.float32), arch.grid_pinpoints,
            arch.vision.image_size, arch.patches_per_side, arch.max_tiles,
            arch.max_image_tokens) for s in [(64, 64), (40, 120)]]
        counts = [a.n_tokens for a in items]
        vision = {"pixels": np.stack([a.pixels for a in items]),
                  "feature_index": np.stack([a.feature_index
                                             for a in items])}
    else:
        counts = [arch.num_image_tokens] * 2
        vision = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    t = max(counts) + 8
    ids = np.full((2, t), 1, np.int32)
    mask = np.zeros((2, t), np.int32)
    for i, n in enumerate(counts):
        row = [2, 3] + [IMG] * n + list(rng.integers(2, 18, size=3 + i))
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask, vision


@pytest.mark.parametrize("kind", ["text", "image"])
@pytest.mark.parametrize("family", LLAVA_FAMILIES)
def test_build_model_encoders_match_jax_on_converted_checkpoints(
        converted, family, kind):
    jdir, pdir = converted[FAMILY_MODEL[family]]
    params, arch, tok, tmpl = build_model(
        ModelConfig(family=ModelFamily(family), checkpoint_path=str(pdir),
                    dtype="float32"), device="cpu")
    jparams, jarch, _, jtmpl = j_build_model(JModelConfig(
        family=JFamily(family), checkpoint_path=str(jdir), dtype="float32"))
    assert dataclasses.asdict(arch) == dataclasses.asdict(jarch)
    assert tmpl.text_prompt() == jtmpl.text_prompt()
    assert arch.text.num_heads // arch.text.num_kv_heads == (
        1 if family == "llava_1_6_vicuna" else 2)
    assert arch.anyres == (family != "llava_1_5")
    rng = np.random.default_rng(len(family))
    ids, mask, vision = (_text_batch(rng) if kind == "text"
                         else _image_batch(arch, rng))
    pvis = jvis = None
    if isinstance(vision, dict):
        pvis = {k: torch.from_numpy(v) for k, v in vision.items()}
        jvis = {k: jnp.asarray(v) for k, v in vision.items()}
    elif vision is not None:
        pvis, jvis = torch.from_numpy(vision), jnp.asarray(vision)
    sparse, dense = mllm.encode(params, arch, torch.from_numpy(ids).long(),
                                torch.from_numpy(mask), pvis)
    jsparse, jdense = jmllm.encode(jparams, jarch, jnp.asarray(ids),
                                   jnp.asarray(mask), jvis)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), **TOL)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse), **TOL)


# Dims of the published config.json files, with the defaults that
# transformers fills in written out (tests have no hub access).
CLIP_L_336 = {"image_size": 336, "patch_size": 14, "hidden_size": 1024,
              "num_hidden_layers": 24, "num_attention_heads": 16,
              "intermediate_size": 4096, "hidden_act": "quick_gelu"}
VICUNA_7B = {"model_type": "llama", "vocab_size": 32064, "hidden_size": 4096,
             "num_hidden_layers": 32, "num_attention_heads": 32,
             "num_key_value_heads": 32, "intermediate_size": 11008,
             "max_position_embeddings": 4096, "rope_theta": 10000.0,
             "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
ANYRES = [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]]
PUBLISHED = {
    "llava_1_5": {  # llava-hf/llava-1.5-7b-hf
        "model_type": "llava", "image_token_index": 32000,
        "vision_feature_layer": -2, "text_config": VICUNA_7B,
        "vision_config": CLIP_L_336},
    "llava_1_6_vicuna": {  # llava-hf/llava-v1.6-vicuna-7b-hf
        "model_type": "llava_next", "image_token_index": 32000,
        "vision_feature_layer": -2, "image_grid_pinpoints": ANYRES,
        "text_config": VICUNA_7B, "vision_config": CLIP_L_336},
    "llava_next_llama3": {  # llava-hf/llama3-llava-next-8b-hf
        "model_type": "llava_next", "image_token_index": 128256,
        "vision_feature_layer": -2, "image_grid_pinpoints": ANYRES,
        "text_config": {
            "model_type": "llama", "vocab_size": 128320,
            "hidden_size": 4096, "num_hidden_layers": 32,
            "num_attention_heads": 32, "num_key_value_heads": 8,
            "intermediate_size": 14336, "max_position_embeddings": 8192,
            "rope_theta": 500000.0, "rms_norm_eps": 1e-5},
        "vision_config": CLIP_L_336},
}
# Where the published config differs from the JAX registry, the registry
# keeps its values (the JAX package's choice) and a converted checkpoint's
# arch.json carries the published ones: LLaVA-NeXT-Llama3's embedding table
# holds 128,320 rows (the added <image> token, padded), its <image> id is
# 128,256 and its context 8,192, against the registry's 128,256 / 128,255 /
# 4,096.
REGISTRY_WINS = {"llava_next_llama3": {
    ("text", "vocab_size"): (128320, 128256),
    ("image_token_id",): (128256, 128255),
    ("text", "max_seq_len"): (8192, 4096)}}


@pytest.mark.parametrize("family", ["llava_1_5", "llava_1_6_vicuna",
                                    "llava_next_llama3"])
def test_arch_from_published_hf_config_equals_both_registries(family):
    got = dataclasses.asdict(convert.arch_from_hf_config(PUBLISHED[family]))
    assert got == dataclasses.asdict(
        jconvert.arch_from_hf_config(PUBLISHED[family]))
    for path, (published, registry_value) in REGISTRY_WINS.get(
            family, {}).items():
        node = got
        for key in path[:-1]:
            node = node[key]
        assert node[path[-1]] == published
        node[path[-1]] = registry_value
    assert got == dataclasses.asdict(
        registry.get_family_spec(ModelFamily(family)).arch)
    assert got == dataclasses.asdict(
        jregistry.get_family_spec(JFamily(family)).arch)


@pytest.mark.parametrize("family", LLAVA_FAMILIES + ["tiny_debug"])
def test_registry_and_manifests_match_jax(family):
    spec = registry.get_family_spec(ModelFamily(family))
    jspec = jregistry.get_family_spec(JFamily(family))
    arch, jarch = spec.arch, jspec.arch
    assert dataclasses.asdict(arch) == dataclasses.asdict(jarch)
    assert spec.hf_repo == jspec.hf_repo
    text = json.dumps(convert.arch_to_manifest(arch), indent=1)
    assert text == json.dumps(jconvert.arch_to_manifest(jarch), indent=1)
    manifest = json.loads(text)
    assert convert.arch_from_manifest(manifest) == arch
    assert jconvert.arch_from_manifest(manifest) == jarch
    # JAX's build_model passes the template through resolve_template, which
    # returns a string-wrapper family's template unchanged
    assert jtemplates.resolve_template(jspec.template, None) is \
        jspec.template
    _assert_templates_equal(spec.template, jspec.template)


def _assert_templates_equal(t, jt):
    assert (t.wrapper, t.image_sep) == (jt.wrapper, jt.image_sep)
    # the port has no image_token / image_wrap: the string-wrapper
    # families keep JAX's defaults
    assert (jt.image_token, jt.image_wrap) == (templates.IMAGE_SLOT,
                                               ("", ""))
    for one_word in (True, False):
        assert t.text_prompt(one_word) == jt.text_prompt(one_word)
        assert t.expand_image(t.image_prompt(one_word), 3) == \
            jt.expand_image(jt.image_prompt(one_word), 3)


@pytest.mark.parametrize("name", ["LLAMA3", "LLAVA_V1_5", "TINY"])
def test_template_strings_equal_jax(name):
    _assert_templates_equal(getattr(templates, name),
                            getattr(jtemplates, name))


@pytest.mark.parametrize("vision_cfg", [
    {"hidden_act": "gelu"},            # HF's exact erf GELU
    {"hidden_act": "gelu_pytorch_tanh"},
    {"hidden_act": "silu"},
])
def test_non_clip_vision_towers_are_refused(vision_cfg):
    """The port builds CLIP's tower only: a config.json whose tower has
    another activation raises instead of loading with the wrong one."""
    cfg = dict(PUBLISHED["llava_1_5"])
    cfg["vision_config"] = dict(CLIP_L_336, **vision_cfg)
    with pytest.raises(NotImplementedError, match="CLIP"):
        convert.arch_from_hf_config(cfg)


@pytest.mark.parametrize("field", [{"use_cls_token": False},
                                   {"act": "gelu"}])
def test_manifest_with_a_non_clip_tower_is_refused(field):
    arch = registry.get_family_spec(ModelFamily.LLAVA_1_5).arch
    manifest = convert.arch_to_manifest(arch)
    manifest["config"]["vision"].update(field)
    (key, value), = field.items()
    # the JAX package builds such towers; the port refuses them
    assert getattr(jconvert.arch_from_manifest(manifest).vision, key) == value
    with pytest.raises(NotImplementedError, match="CLIP"):
        convert.arch_from_manifest(manifest)


def test_build_model_manifest_wins_and_registry_default(tmp_path):
    tiny = registry.tiny_debug_arch(ModelConfig())
    params = mllm.init_params(tiny, torch.Generator().manual_seed(0), "cpu",
                              torch.float32)
    host = jax.tree_util.tree_map(lambda t: t.numpy(), params)
    for name, manifest in (("with", True), ("without", False)):
        (tmp_path / name).mkdir()
        with open(tmp_path / name / "params.pkl", "wb") as f:
            pickle.dump(host, f)
        if manifest:
            (tmp_path / name / "arch.json").write_text(
                json.dumps(convert.arch_to_manifest(tiny)))
    loaded, arch, tok, tmpl = build_model(ModelConfig(
        family=ModelFamily.LLAVA_1_5, checkpoint_path=str(tmp_path / "with"),
        dtype="bfloat16"), device="cpu")
    assert arch == tiny and tok is None and tmpl is templates.LLAVA_V1_5
    assert loaded["text"]["embed"].dtype == torch.bfloat16
    _assert_trees_bit_equal(
        jax.tree_util.tree_map(lambda t: t.float().numpy(), loaded),
        jax.tree_util.tree_map(
            lambda t: t.bfloat16().float().numpy(), params))
    # a .pkl path and a directory without a manifest: the registry's arch
    _, arch, _, _ = build_model(ModelConfig(
        family=ModelFamily.E5_V,
        checkpoint_path=str(tmp_path / "without" / "params.pkl")),
        device="cpu")
    assert arch == registry.get_family_spec(ModelFamily.E5_V).arch
    with pytest.raises(FileNotFoundError, match="royokong/e5-v"):
        build_model(ModelConfig(family=ModelFamily.E5_V), device="cpu")
    # the chat-template families build as the JAX package builds them: the
    # manifest's arch, the registry's template through resolve_template
    # (no tokenizer: unchanged)
    for family in (ModelFamily.QWEN2_5_VL, ModelFamily.INTERNVL2_5):
        _, arch, tok, tmpl = build_model(
            ModelConfig(family=family, checkpoint_path=str(tmp_path / "with")),
            device="cpu")
        jspec = jregistry.get_family_spec(JFamily(family.value))
        assert arch == tiny and tok is None
        assert dataclasses.asdict(tmpl) == dataclasses.asdict(jspec.template)
    qwen_cfg = {"model_type": "qwen2_5_vl",
                "vision_config": {"hidden_size": 1280, "depth": 32,
                                  "num_heads": 16, "intermediate_size": 3420,
                                  "out_hidden_size": 3584, "patch_size": 14},
                "text_config": {"vocab_size": 152064, "hidden_size": 3584,
                                "num_hidden_layers": 28,
                                "num_attention_heads": 28,
                                "num_key_value_heads": 4,
                                "intermediate_size": 18944,
                                "model_type": "qwen2_5_vl_text",
                                "rope_scaling": {"mrope_section":
                                                 [16, 24, 24]}}}
    assert dataclasses.asdict(convert.arch_from_hf_config(qwen_cfg)) == \
        dataclasses.asdict(jconvert.arch_from_hf_config(qwen_cfg))
    manifest = json.loads(json.dumps(jconvert.arch_to_manifest(
        jregistry._internvl2_5_arch())))
    assert dataclasses.asdict(convert.arch_from_manifest(manifest)) == \
        dataclasses.asdict(jregistry._internvl2_5_arch())


@pytest.mark.parametrize("encode_type", ["text", "image"])
def test_cli_encode_loads_a_converted_checkpoint(converted, tmp_path,
                                                 capsys, encode_type):
    root = tmp_path / "data"
    (root / "flickr").mkdir(parents=True)
    rng = np.random.default_rng(5)
    lines = ["imgid,filename,caption,sentid"]
    for i in range(3):
        for c in range(2):
            cap = " ".join(rng.choice(WORDS, size=5))
            lines.append(f"{i},{i}.jpg,{cap},{2 * i + c}")
    (root / "flickr" / "flickr_test.csv").write_text("\n".join(lines) + "\n")
    ckpt = tmp_path / "ckpt"
    shutil.copytree(converted["anyres_g2"][1], ckpt)
    cli_encode.main([
        "--dataset", "flickr", "--data-root", str(root), "--family",
        "llava_next_llama3", "--checkpoint-path", str(ckpt), "--dtype",
        "float32", "--device", "cpu", "--batch-size", "4", "--encode-type",
        encode_type, "--dense-output-dir", str(tmp_path / "dense"),
        "--sparse-output-dir", str(tmp_path / "sparse")])
    dense_dir, sparse_dir = capsys.readouterr().out.split()
    with open(f"{dense_dir}/corpus_0.pkl", "rb") as f:
        vecs, ids = pickle.load(f)
    n = 6 if encode_type == "text" else 3
    assert np.asarray(vecs).shape == (n, 32) and len(ids) == n
    assert np.isfinite(np.asarray(vecs)).all()
