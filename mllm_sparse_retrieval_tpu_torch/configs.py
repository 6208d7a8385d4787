"""Configuration dataclasses the port reads (a copy of the JAX package's
``configs.py``, cut to the classes the ported paths use)."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class ModelFamily(str, enum.Enum):
    """Supported MLLM families: the four LLaVA families, Qwen2.5-VL and
    InternVL2.5 (from converted checkpoints), and the tiny random ones."""

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
class DataConfig:
    """Dataset selection and host-side collation."""

    dataset_name: str = "flickr"          # 'coco' | 'flickr'
    data_root: str = "/root/reference/data"
    split: str = "test"
    per_device_batch_size: int = 4
    encode_is_query: bool = False
    use_few_shot: bool = False
    few_shot_sum: int = 200               # {name}_{split}_{few_shot_sum}.csv
    image_root: Optional[str] = None      # override image directory


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
    checkpoint_path: Optional[str] = None  # converted checkpoint to load
    dtype: str = "bfloat16"                # compute dtype on the card
    # tiny-debug architecture knobs (real families carry their own
    # architecture in models/registry.py)
    tiny_vocab_size: int = 512
    tiny_hidden_size: int = 128
    tiny_num_layers: int = 2
    tiny_num_heads: int = 4
    tiny_image_size: int = 64
    tiny_patch_size: int = 16


@dataclass(frozen=True)
class SearchConfig:
    """Query-time settings."""

    passage_reps: Optional[str] = None    # dir with dense corpus shards
    sparse_index: Optional[str] = None    # dir with impact index
    depth: int = 1000
    alpha: float = 0.5                    # dense weight in min-max fusion
    batch_size: int = 128
    remove_query: bool = False            # drop self-hit (doc id == query id)
    query_type: str = "text"              # 'text' | 'image'
    save_dir: Optional[str] = None


@dataclass(frozen=True)
class TrainConfig:
    """Contrastive LoRA fine-tuning (reference: src/train.py + scripts/train.sh).

    Every field and default of the JAX package's ``TrainConfig``. The port's
    trainer runs on one device: it raises for a mesh and for
    ``load_kbit > 0`` (``models/quantization.py`` is not ported), and, as the
    JAX trainer does without a mesh, ignores ``gather_save_gradient``,
    ``shard_optimizer_state`` and ``shard_params_data_axis``.
    """

    learning_rate: float = 5e-5
    num_epochs: int = 5
    tau: float = 0.05                     # scripts/train.sh:30 (default 0.1 in code)
    gather_save_gradient: bool = True     # grads flow through gathered negatives
    lora_rank: int = 8
    lora_alpha: int = 16
    # train-time dropout on the DECODER LoRA paths (scripts/train.sh
    # --lora_dropout 0.1; PEFT placement: dropout on the adapter input).
    # The per-step randomness is derived from (seed, step), so checkpoint
    # resume replays exactly. Vision/projector adapters (off in the
    # reference recipe) train without dropout.
    lora_dropout: float = 0.1
    # k-bit base-weight loading (reference --load_kbit {4,8}); 0 = full
    # precision. Not ported: the trainer raises for any other value.
    load_kbit: int = 0
    train_vision_lora: bool = False
    train_projector_lora: bool = False
    weight_decay: float = 0.0
    warmup_steps: int = 0
    # 'linear' reproduces HF Trainer's default lr_scheduler_type (decay to 0
    # over total_steps); 'cosine' = warmup + cosine decay; 'constant' holds
    # learning_rate.
    lr_schedule: str = "constant"
    total_steps: int = 0                  # required for 'linear' decay
    # HF Trainer's implicit default (max_grad_norm=1.0); 0 disables.
    max_grad_norm: float = 1.0
    # Gradient accumulation: the step batch splits into this many
    # microbatches; grads average across them before one optimizer update.
    # Contrastive in-batch negatives come from the MICRObatch.
    grad_accum_steps: int = 1
    seed: int = 0
    shard_optimizer_state: bool = True    # ZeRO-1 equivalent over the data axis
    shard_params_data_axis: bool = False  # ZeRO-3/FSDP equivalent (ds_configs/zero3.json)
    train_full: bool = False              # full finetune (no LoRA; reference --lora off)
    remat: bool = False                   # gradient-checkpoint decoder blocks
    output_dir: str = "./output"
    checkpoint_every_steps: int = 0       # 0 = final-only (reference default)
