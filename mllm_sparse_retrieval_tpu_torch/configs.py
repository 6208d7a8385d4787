"""Configuration dataclasses the port reads (a copy of the JAX package's
``configs.py``, cut to the fields this slice uses)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ModelFamily(str, enum.Enum):
    """Supported MLLM families; the port builds ``LLAVA_NEXT_LLAMA3`` and
    ``TINY_DEBUG``."""

    LLAVA_NEXT_LLAMA3 = "llava_next_llama3"   # llava-hf/llama3-llava-next-8b
    LLAVA_1_5 = "llava_1_5"                    # llava-hf/llava-1.5-7b
    LLAVA_1_6_VICUNA = "llava_1_6_vicuna"      # llava-hf/llava-v1.6-vicuna-7b
    E5_V = "e5_v"                              # royokong/e5-v (llava-next based)
    QWEN2_5_VL = "qwen2_5_vl"                  # Qwen/Qwen2.5-VL-{3B,7B}-Instruct
    INTERNVL2_5 = "internvl2_5"                # OpenGVLab/InternVL2_5-{4B,8B}
    TINY_DEBUG = "tiny_debug"                  # random tiny LLaVA-style model
    TINY_QWEN_DEBUG = "tiny_qwen_debug"        # random tiny Qwen2.5-VL-style model

class RepsLoc(str, enum.Enum):
    """Which token position supplies the representations: the last non-pad
    position (``BEFORE_PAD``) or the raw final position (``AFTER_PAD``)."""

    BEFORE_PAD = "before_pad"
    AFTER_PAD = "after_pad"

@dataclass(frozen=True)
class SparseConfig:
    """SPLADE-style term selection knobs."""

    sparse_length: int = 128              # top-k terms kept per vector
    sparse_manual: bool = False           # full-vocab top-k even for text
    is_filtered: bool = True              # strip one leading non-[a-z] char
    num_expanded_tokens: int = 0          # expansion terms outside the text
    quantization_scale: float = 100.0     # round(weight * scale) -> int
    fallback_top_k: int = 10              # when a caption has no candidate terms

@dataclass(frozen=True)
class ModelConfig:
    """Model identity + representation extraction."""

    family: ModelFamily = ModelFamily.TINY_DEBUG
    dtype: str = "bfloat16"                # compute dtype on the card
    # tiny-debug architecture knobs (real families carry their own
    # architecture in models/registry.py)
    tiny_vocab_size: int = 512
    tiny_hidden_size: int = 128
    tiny_num_layers: int = 2
    tiny_num_heads: int = 4
    tiny_image_size: int = 64
    tiny_patch_size: int = 16
