"""Model-family registry.

``LLAVA_NEXT_LLAMA3`` is the reference's default model (LLaVA-NeXT-Llama3-8B:
a CLIP ViT-L/14-336 vision tower, 24 layers, hidden 1024, 16 heads, with the
anyres multi-patch path; a 32-layer decoder, hidden 4096, 32 heads / 8 KV
heads, FFN 14336, vocab 128,256, RoPE theta 5e5). ``E5_V`` shares its
architecture; ``LLAVA_1_5`` (fixed 336 px grid, 576 image tokens) and
``LLAVA_1_6_VICUNA`` (the 1.5 dims with the anyres path) have a Vicuna-7B
decoder with 32 KV heads. The chat-template families: ``QWEN2_5_VL``
(the windowed ViT at native resolution and an M-RoPE Qwen2.5 backbone; the
family default is the 3B, ``_qwen2_5_vl_7b_arch`` the 7B) and
``INTERNVL2_5`` (InternViT-300M with dynamic tiling and a Qwen2-shaped 8B
backbone, 28 query / 4 KV heads; ``_internvl2_5_4b_arch`` the 4B). The
dims are the JAX registry's. Real families load converted checkpoints
(``models/convert.py``), whose ``arch.json`` wins over these dims.
``TINY_DEBUG`` and ``TINY_QWEN_DEBUG`` are the self-contained random tiny
families that tests use.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, ModelFamily
from mllm_sparse_retrieval_tpu_torch.models import (
    internvl, mllm, qwen_vl, templates)
from mllm_sparse_retrieval_tpu_torch.models.anyres import (
    DEFAULT_GRID_PINPOINTS)
from mllm_sparse_retrieval_tpu_torch.models.internvl import (
    InternViTConfig, InternVLConfig)
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
from mllm_sparse_retrieval_tpu_torch.models.qwen_vl import (
    QwenViTConfig, QwenVLConfig)
from mllm_sparse_retrieval_tpu_torch.models.templates import PromptTemplate
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig


@dataclass(frozen=True)
class FamilySpec:
    family: ModelFamily
    arch: object            # MLLMConfig, QwenVLConfig or InternVLConfig
    template: PromptTemplate
    hf_repo: Optional[str] = None  # provenance note only


def _llava_next_llama3_arch() -> MLLMConfig:
    return MLLMConfig(
        vision=ViTConfig(image_size=336, patch_size=14, hidden_size=1024,
                         num_layers=24, num_heads=16, feature_layer=-2),
        text=LlamaConfig(vocab_size=128256, hidden_size=4096, num_layers=32,
                         num_heads=32, num_kv_heads=8,
                         intermediate_size=14336, rope_theta=500000.0),
        image_token_id=128256 - 1,
        grid_pinpoints=DEFAULT_GRID_PINPOINTS)


def _llava_1_5_arch() -> MLLMConfig:
    return MLLMConfig(
        vision=ViTConfig(image_size=336, patch_size=14, hidden_size=1024,
                         num_layers=24, num_heads=16, feature_layer=-2),
        text=LlamaConfig(vocab_size=32064, hidden_size=4096, num_layers=32,
                         num_heads=32, num_kv_heads=32,
                         intermediate_size=11008, rope_theta=10000.0),
        image_token_id=32000)


def _llava_1_6_vicuna_arch() -> MLLMConfig:
    """LLaVA-1.6 (NeXT) Vicuna-7B: the 1.5 tower and decoder dims with the
    anyres multi-patch image path."""
    base = _llava_1_5_arch()
    return MLLMConfig(vision=base.vision, text=base.text,
                      image_token_id=base.image_token_id,
                      grid_pinpoints=DEFAULT_GRID_PINPOINTS)


def _qwen2_5_vl_3b_arch() -> QwenVLConfig:
    """Qwen2.5-VL-3B, the family default: the windowed ViT (32 blocks,
    1,280 wide, full attention at blocks 7, 15, 23 and 31) at native
    resolution, and a 36-layer M-RoPE Qwen2.5 backbone with a tied head."""
    return QwenVLConfig(
        vision=QwenViTConfig(hidden_size=1280, depth=32, num_heads=16,
                             intermediate_size=3420, out_hidden_size=2048,
                             patch_size=14, spatial_merge_size=2,
                             window_size=112,
                             fullatt_block_indexes=(7, 15, 23, 31)),
        text=LlamaConfig(vocab_size=151936, hidden_size=2048, num_layers=36,
                         num_heads=16, num_kv_heads=2,
                         intermediate_size=11008, rope_theta=1000000.0,
                         qkv_bias=True, tie_lm_head=True, rms_eps=1e-6,
                         mrope_section=(16, 24, 24)),
        image_token_id=151655, vision_start_token_id=151652,
        grid_h=32, grid_w=32,
        native_resolution=True)


def _qwen2_5_vl_7b_arch() -> QwenVLConfig:
    """Qwen2.5-VL-7B: the 3B's tower, its merger projecting to the
    backbone's 3,584 (``out_hidden_size``), and a 28-layer backbone of 3,584
    (28 query / 4 KV heads), untied head. The JAX registry keeps the 3B's
    ``out_hidden_size`` of 2,048 here, so its 7B cannot splice its image
    features into its 3,584-wide prompts; the published 7B config has
    3,584. A checkpoint selects its size through its ``arch.json``."""
    base = _qwen2_5_vl_3b_arch()
    return QwenVLConfig(
        vision=dataclasses.replace(base.vision, out_hidden_size=3584),
        text=LlamaConfig(vocab_size=152064, hidden_size=3584, num_layers=28,
                         num_heads=28, num_kv_heads=4,
                         intermediate_size=18944, max_seq_len=128000,
                         rope_theta=1000000.0,
                         qkv_bias=True, tie_lm_head=False, rms_eps=1e-6,
                         mrope_section=(16, 24, 24)),
        image_token_id=base.image_token_id,
        vision_start_token_id=base.vision_start_token_id,
        grid_h=base.grid_h, grid_w=base.grid_w,
        native_resolution=True)


def _internvl2_5_arch() -> InternVLConfig:
    """InternVL2.5-8B (HF-integrated layout): the InternViT-300M tower
    (448 px tiles, 256 tokens a tile after the pixel shuffle) and the JAX
    registry's Qwen2-shaped backbone (3,584 wide, 28 layers, 28 / 4 heads,
    qkv bias, vocab 151,674)."""
    return InternVLConfig(
        vision=InternViTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                               intermediate_size=4096, image_size=448,
                               patch_size=14, norm_type="layer_norm",
                               use_qk_norm=False),
        text=LlamaConfig(vocab_size=151674, hidden_size=3584, num_layers=28,
                         num_heads=28, num_kv_heads=4,
                         intermediate_size=18944, rope_theta=1000000.0,
                         qkv_bias=True, rms_eps=1e-6),
        image_token_id=151667)


def _internvl2_5_4b_arch() -> InternVLConfig:
    """InternVL2.5-4B: the 8B's tower with a Qwen2.5-3B backbone (36 layers
    of 2,048)."""
    base = _internvl2_5_arch()
    return InternVLConfig(
        vision=base.vision,
        text=LlamaConfig(vocab_size=151674, hidden_size=2048, num_layers=36,
                         num_heads=16, num_kv_heads=2,
                         intermediate_size=11008, rope_theta=1000000.0,
                         qkv_bias=True, rms_eps=1e-6),
        image_token_id=base.image_token_id)


def _tiny_qwen_debug_arch(model_cfg: Optional[ModelConfig] = None
                          ) -> QwenVLConfig:
    m = model_cfg or ModelConfig()
    hd = m.tiny_hidden_size // m.tiny_num_heads
    if (hd // 2) % 4:
        raise ValueError("tiny qwen needs head_dim/2 divisible by 4")
    sec = (hd // 2 - 2 * (hd // 8), hd // 8, hd // 8)
    return QwenVLConfig(
        vision=QwenViTConfig(hidden_size=64, depth=2, num_heads=4,
                             intermediate_size=128,
                             out_hidden_size=m.tiny_hidden_size,
                             patch_size=14, spatial_merge_size=2,
                             window_size=56, fullatt_block_indexes=(1,)),
        text=LlamaConfig(vocab_size=m.tiny_vocab_size,
                         hidden_size=m.tiny_hidden_size,
                         num_layers=m.tiny_num_layers,
                         num_heads=m.tiny_num_heads,
                         num_kv_heads=max(1, m.tiny_num_heads // 2),
                         intermediate_size=m.tiny_hidden_size * 4,
                         rope_theta=10000.0, qkv_bias=True,
                         mrope_section=sec),
        image_token_id=4,  # WordPieceLiteTokenizer.IMAGE
        vision_start_token_id=2,
        grid_h=8, grid_w=8)


def tiny_debug_arch(model_cfg: Optional[ModelConfig] = None) -> MLLMConfig:
    m = model_cfg or ModelConfig()
    return MLLMConfig(
        vision=ViTConfig(
            image_size=m.tiny_image_size, patch_size=m.tiny_patch_size,
            hidden_size=m.tiny_hidden_size, num_layers=m.tiny_num_layers,
            num_heads=m.tiny_num_heads, feature_layer=-2),
        text=LlamaConfig(
            vocab_size=m.tiny_vocab_size, hidden_size=m.tiny_hidden_size,
            num_layers=m.tiny_num_layers, num_heads=m.tiny_num_heads,
            num_kv_heads=max(1, m.tiny_num_heads // 2),
            intermediate_size=m.tiny_hidden_size * 4, rope_theta=10000.0),
        image_token_id=4)  # WordPieceLiteTokenizer.IMAGE


_SPECS: Dict[ModelFamily, Callable[[], object]] = {
    ModelFamily.LLAVA_NEXT_LLAMA3: _llava_next_llama3_arch,
    ModelFamily.LLAVA_1_5: _llava_1_5_arch,
    ModelFamily.LLAVA_1_6_VICUNA: _llava_1_6_vicuna_arch,
    ModelFamily.E5_V: _llava_next_llama3_arch,
    ModelFamily.QWEN2_5_VL: _qwen2_5_vl_3b_arch,
    ModelFamily.INTERNVL2_5: _internvl2_5_arch,
}

_TEMPLATES: Dict[ModelFamily, PromptTemplate] = {
    ModelFamily.TINY_QWEN_DEBUG: templates.TINY,
    ModelFamily.LLAVA_NEXT_LLAMA3: templates.LLAMA3,
    ModelFamily.E5_V: templates.LLAMA3,
    ModelFamily.LLAVA_1_5: templates.LLAVA_V1_5,
    ModelFamily.LLAVA_1_6_VICUNA: templates.LLAVA_V1_5,
    # chat-message families: rendered through the checkpoint's own HF chat
    # template when one loads (templates.resolve_template); these wrappers
    # reproduce the official templates' output otherwise
    ModelFamily.QWEN2_5_VL: templates.QWEN2_5_VL,
    ModelFamily.INTERNVL2_5: templates.INTERNVL2_5,
    ModelFamily.TINY_DEBUG: templates.TINY,
}

_HF_REPOS: Dict[ModelFamily, str] = {
    ModelFamily.LLAVA_NEXT_LLAMA3: "llava-hf/llama3-llava-next-8b-hf",
    ModelFamily.LLAVA_1_5: "llava-hf/llava-1.5-7b-hf",
    ModelFamily.LLAVA_1_6_VICUNA: "llava-hf/llava-v1.6-vicuna-7b-hf",
    ModelFamily.E5_V: "royokong/e5-v",
    ModelFamily.QWEN2_5_VL: "Qwen/Qwen2.5-VL-3B-Instruct",
    ModelFamily.INTERNVL2_5: "OpenGVLab/InternVL2_5-8B",
}


def get_family_spec(family: ModelFamily,
                    model_cfg: Optional[ModelConfig] = None) -> FamilySpec:
    if family == ModelFamily.TINY_DEBUG:
        arch = tiny_debug_arch(model_cfg)
    elif family == ModelFamily.TINY_QWEN_DEBUG:
        arch = _tiny_qwen_debug_arch(model_cfg)
    else:
        arch = _SPECS[family]()
    return FamilySpec(family=family, arch=arch, template=_TEMPLATES[family],
                      hf_repo=_HF_REPOS.get(family))


def init_params(arch, generator: torch.Generator, device="cuda",
                dtype=torch.bfloat16) -> Dict:
    """Random weights of any family's ``arch``, drawn on ``device`` from
    ``generator`` (the family module's ``init_params``)."""
    if isinstance(arch, QwenVLConfig):
        return qwen_vl.init_params(arch, generator, device, dtype)
    if isinstance(arch, InternVLConfig):
        return internvl.init_params(arch, generator, device, dtype)
    return mllm.init_params(arch, generator, device, dtype)


def build_model(model_cfg: ModelConfig,
                captions: Optional[Sequence[str]] = None, seed: int = 0,
                device="cuda") -> Tuple[Dict, object, object,
                                        PromptTemplate]:
    """``(params, arch, tokenizer, template)`` for a family, on ``device``.

    TINY_DEBUG / TINY_QWEN_DEBUG: random weights drawn from ``seed`` + a
    tokenizer built from ``captions``. Real families load
    ``model_cfg.checkpoint_path``, a directory converted by
    ``models/convert.py``; its ``arch.json`` manifest's dims win over the
    registry's, and its tokenizer is None where it ships none or
    ``transformers`` is missing. The template goes through
    ``templates.resolve_template`` with that tokenizer (the chat families
    render through its chat template when it has one). Without a
    checkpoint they raise ``FileNotFoundError``.
    """
    spec = get_family_spec(model_cfg.family, model_cfg)
    dtype = torch.bfloat16 if model_cfg.dtype == "bfloat16" else torch.float32
    if model_cfg.family in (ModelFamily.TINY_DEBUG,
                            ModelFamily.TINY_QWEN_DEBUG):
        tok = WordPieceLiteTokenizer.from_corpus_captions(
            captions or ["a photo of a thing"],
            vocab_size=model_cfg.tiny_vocab_size)
        if tok.vocab_size > spec.arch.text.vocab_size:
            raise ValueError(
                f"tokenizer vocab {tok.vocab_size} exceeds model vocab "
                f"{spec.arch.text.vocab_size}; raise "
                f"ModelConfig.tiny_vocab_size")
        generator = torch.Generator(device=device).manual_seed(seed)
        params = init_params(spec.arch, generator, device, dtype)
        return params, spec.arch, tok, spec.template

    if model_cfg.checkpoint_path is None:
        raise FileNotFoundError(
            f"family {model_cfg.family.value} needs converted weights (a "
            f"checkpoint from {spec.hf_repo}); set "
            f"ModelConfig.checkpoint_path. Use models/convert.py to convert "
            f"an HF checkpoint directory.")
    from mllm_sparse_retrieval_tpu_torch.models import convert
    params, tok, ckpt_arch = convert.load_converted(
        model_cfg.checkpoint_path, spec, dtype, device)
    template = templates.resolve_template(spec.template, tok)
    return params, ckpt_arch or spec.arch, tok, template
