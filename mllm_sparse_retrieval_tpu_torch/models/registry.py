"""Model-family registry.

``LLAVA_NEXT_LLAMA3`` is the reference's default model (LLaVA-NeXT-Llama3-8B:
a CLIP ViT-L/14-336 vision tower, 24 layers, hidden 1024, 16 heads, with the
anyres multi-patch path; a 32-layer decoder, hidden 4096, 32 heads / 8 KV
heads, FFN 14336, vocab 128,256, RoPE theta 5e5). ``TINY_DEBUG`` is the
self-contained random tiny fixed-grid family that tests use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

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


_TEMPLATES: Dict[ModelFamily, PromptTemplate] = {
    ModelFamily.LLAVA_NEXT_LLAMA3: templates.LLAMA3,
    ModelFamily.TINY_DEBUG: templates.TINY,
}

_HF_REPOS: Dict[ModelFamily, str] = {
    ModelFamily.LLAVA_NEXT_LLAMA3: "llava-hf/llama3-llava-next-8b-hf",
}


def get_family_spec(family: ModelFamily,
                    model_cfg: Optional[ModelConfig] = None) -> FamilySpec:
    if family == ModelFamily.TINY_DEBUG:
        arch = tiny_debug_arch(model_cfg)
    elif family == ModelFamily.LLAVA_NEXT_LLAMA3:
        arch = _llava_next_llama3_arch()
    else:
        raise NotImplementedError(f"family {family.value} is not ported yet")
    return FamilySpec(family=family, arch=arch, template=_TEMPLATES[family],
                      hf_repo=_HF_REPOS.get(family))


def build_model(model_cfg: ModelConfig,
                captions: Optional[Sequence[str]] = None, seed: int = 0,
                device="cuda") -> Tuple[Dict, MLLMConfig, object,
                                        PromptTemplate]:
    """``(params, arch, tokenizer, template)`` for a family.

    TINY_DEBUG: random weights drawn on ``device`` + a tokenizer built from
    ``captions``. Real families need converted checkpoints, whose loading
    waits for a later slice; for them this raises.
    """
    spec = get_family_spec(model_cfg.family, model_cfg)
    if model_cfg.family != ModelFamily.TINY_DEBUG:
        raise FileNotFoundError(
            f"family {model_cfg.family.value} needs converted weights "
            f"(from {spec.hf_repo}); checkpoint loading is not ported yet — "
            f"draw random weights with mllm.init_params instead")
    dtype = torch.bfloat16 if model_cfg.dtype == "bfloat16" else torch.float32
    tok = WordPieceLiteTokenizer.from_corpus_captions(
        captions or ["a photo of a thing"],
        vocab_size=model_cfg.tiny_vocab_size)
    if tok.vocab_size > spec.arch.text.vocab_size:
        raise ValueError(
            f"tokenizer vocab {tok.vocab_size} exceeds model vocab "
            f"{spec.arch.text.vocab_size}; raise ModelConfig.tiny_vocab_size")
    generator = torch.Generator(device=device).manual_seed(seed)
    params = mllm.init_params(spec.arch, generator, device, dtype)
    return params, spec.arch, tok, spec.template
