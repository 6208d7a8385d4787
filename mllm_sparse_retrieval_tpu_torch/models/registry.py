"""Model-family registry.

``LLAVA_NEXT_LLAMA3`` is the reference's default model (LLaVA-NeXT-Llama3-8B:
a CLIP ViT-L/14-336 vision tower, 24 layers, hidden 1024, 16 heads, with the
anyres multi-patch path; a 32-layer decoder, hidden 4096, 32 heads / 8 KV
heads, FFN 14336, vocab 128,256, RoPE theta 5e5). ``E5_V`` shares its
architecture; ``LLAVA_1_5`` (fixed 336 px grid, 576 image tokens) and
``LLAVA_1_6_VICUNA`` (the 1.5 dims with the anyres path) have a Vicuna-7B
decoder with 32 KV heads. Real families load converted checkpoints
(``models/convert.py``). ``TINY_DEBUG`` is the self-contained random tiny
fixed-grid family that tests use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, ModelFamily
from mllm_sparse_retrieval_tpu_torch.models import mllm, templates
from mllm_sparse_retrieval_tpu_torch.models.anyres import (
    DEFAULT_GRID_PINPOINTS)
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
from mllm_sparse_retrieval_tpu_torch.models.templates import PromptTemplate
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig


@dataclass(frozen=True)
class FamilySpec:
    family: ModelFamily
    arch: MLLMConfig
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


_SPECS: Dict[ModelFamily, Callable[[], MLLMConfig]] = {
    ModelFamily.LLAVA_NEXT_LLAMA3: _llava_next_llama3_arch,
    ModelFamily.LLAVA_1_5: _llava_1_5_arch,
    ModelFamily.LLAVA_1_6_VICUNA: _llava_1_6_vicuna_arch,
    ModelFamily.E5_V: _llava_next_llama3_arch,
}

_TEMPLATES: Dict[ModelFamily, PromptTemplate] = {
    ModelFamily.LLAVA_NEXT_LLAMA3: templates.LLAMA3,
    ModelFamily.E5_V: templates.LLAMA3,
    ModelFamily.LLAVA_1_5: templates.LLAVA_V1_5,
    ModelFamily.LLAVA_1_6_VICUNA: templates.LLAVA_V1_5,
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
    elif family in _SPECS:
        arch = _SPECS[family]()
    else:
        raise NotImplementedError(
            f"family {family.value} is not ported yet (ROADMAP Queue 1 #6: "
            f"models/qwen_vl.py, models/internvl.py)")
    return FamilySpec(family=family, arch=arch, template=_TEMPLATES[family],
                      hf_repo=_HF_REPOS.get(family))


def build_model(model_cfg: ModelConfig,
                captions: Optional[Sequence[str]] = None, seed: int = 0,
                device="cuda") -> Tuple[Dict, MLLMConfig, object,
                                        PromptTemplate]:
    """``(params, arch, tokenizer, template)`` for a family, on ``device``.

    TINY_DEBUG: random weights drawn from ``seed`` + a tokenizer built from
    ``captions``. Real families load ``model_cfg.checkpoint_path``, a
    directory converted by ``models/convert.py``; its ``arch.json``
    manifest's dims win over the registry's, and its tokenizer is None
    where it ships none or ``transformers`` is missing. Without a checkpoint
    they raise ``FileNotFoundError``.
    """
    spec = get_family_spec(model_cfg.family, model_cfg)
    dtype = torch.bfloat16 if model_cfg.dtype == "bfloat16" else torch.float32
    if model_cfg.family == ModelFamily.TINY_DEBUG:
        tok = WordPieceLiteTokenizer.from_corpus_captions(
            captions or ["a photo of a thing"],
            vocab_size=model_cfg.tiny_vocab_size)
        if tok.vocab_size > spec.arch.text.vocab_size:
            raise ValueError(
                f"tokenizer vocab {tok.vocab_size} exceeds model vocab "
                f"{spec.arch.text.vocab_size}; raise "
                f"ModelConfig.tiny_vocab_size")
        generator = torch.Generator(device=device).manual_seed(seed)
        params = mllm.init_params(spec.arch, generator, device, dtype)
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
    return params, ckpt_arch or spec.arch, tok, spec.template
