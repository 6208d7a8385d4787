"""Model-agnostic encode dispatch (the JAX package's ``models/api.py``).

The LLaVA families (``models/mllm.py``) consume pixel grids or the anyres
dict; InternVL2.5 (``models/internvl.py``) consumes dynamic tiles; the
Qwen2.5-VL family (``models/qwen_vl.py``) consumes pre-patchified sequences
plus M-RoPE position ids. This module gives the pipelines one surface:

- ``encode_any(params, arch, ids, mask, vision_input, ...)``
- ``image_input_spec(arch)``: how to preprocess an image for the family and
  how many image tokens its prompt carries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.models import anyres as A
from mllm_sparse_retrieval_tpu_torch.models import internvl, mllm, qwen_vl
from mllm_sparse_retrieval_tpu_torch.models.internvl import InternVLConfig
from mllm_sparse_retrieval_tpu_torch.models.qwen_vl import QwenVLConfig


def encode_any(params, arch, input_ids, attention_mask, vision_input=None,
               reps_loc: RepsLoc = RepsLoc.BEFORE_PAD, lora=None,
               position_ids=None, remat: bool = False,
               allow_flash: bool = True, lora_seed: Optional[int] = None,
               lora_dropout: float = 0.0):
    """``(sparse [B, V], dense [B, H])`` for any family, in the JAX
    package's argument order. ``vision_input`` is a fixed-grid pixel tensor,
    the anyres dict (``mllm.forward_hidden``), InternVL's ``[B, tiles, S,
    S, 3]`` tiles, or Qwen's patches (a tensor, or the native dict);
    ``position_ids`` (M-RoPE, ``[3, B, T]``) belong to the Qwen2.5-VL
    family, and the other families ignore them, as in the JAX package.
    ``remat`` checkpoints the decoder blocks; ``lora_seed`` +
    ``lora_dropout`` enable train-time dropout on the decoder adapters
    (``models/llama.py``); inference callers pass neither."""
    if isinstance(arch, QwenVLConfig):
        return qwen_vl.encode(params, arch, input_ids, attention_mask,
                              patches=vision_input,
                              position_ids=position_ids,
                              reps_loc=reps_loc, lora=lora, remat=remat,
                              allow_flash=allow_flash, lora_seed=lora_seed,
                              lora_dropout=lora_dropout)
    if isinstance(arch, InternVLConfig):
        return internvl.encode(params, arch, input_ids, attention_mask,
                               vision_input, reps_loc, lora, remat=remat,
                               allow_flash=allow_flash, lora_seed=lora_seed,
                               lora_dropout=lora_dropout)
    return mllm.encode(params, arch, input_ids, attention_mask,
                       vision_input, reps_loc, lora, remat=remat,
                       allow_flash=allow_flash, lora_seed=lora_seed,
                       lora_dropout=lora_dropout)


@dataclass(frozen=True)
class ImageInputSpec:
    """How a family consumes images.

    Fixed families (``variable=False``): every image maps to the same token
    count; ``preprocess`` converts a square ``image_size`` pixel grid into
    the model's vision input.

    Variable families (``variable=True``: LLaVA-NeXT anyres, InternVL
    dynamic tiling, Qwen native resolution): the token count depends on the
    original image size. ``preprocess_example`` maps a raw image ([H, W, 3]
    float in [0, 1], not pre-resized) to ``(vision_item, n_tokens)`` with
    static per-example shapes; ``batch_vision`` stacks items into the
    model's vision input (an array or a dict of arrays);
    ``max_image_tokens`` bounds n_tokens so callers can pad prompts to one
    fixed length. ``needs_mrope``: the family takes M-RoPE position ids
    (fixed: ``mrope_ids_for_batch``; variable: ``mrope_from_batch(ids,
    mask, vision_batch)``, from each example's own grid).
    """

    num_image_tokens: int
    image_size: int                       # square pixel size (fixed families)
    preprocess: Optional[Callable] = None
    needs_mrope: bool = False
    variable: bool = False
    preprocess_example: Optional[Callable] = None
    batch_vision: Optional[Callable] = None
    max_image_tokens: int = 0
    mrope_from_batch: Optional[Callable] = None


def image_input_spec(arch) -> ImageInputSpec:
    if isinstance(arch, QwenVLConfig):
        if arch.native_resolution:
            # the HF processor's default: per-image smart-resized grids,
            # layouts as host tables batched beside the patches
            def prep_native(image: np.ndarray):
                return qwen_vl.preprocess_native(image, arch)

            def mrope_fb(ids, mask, vision_batch):
                grids = np.asarray(vision_batch["grid_hw"])
                thw = np.concatenate(
                    [np.ones((grids.shape[0], 1), np.int64), grids], axis=1)
                return qwen_vl.mrope_position_ids(
                    np.asarray(ids), np.asarray(mask), arch.image_token_id,
                    thw, arch.vision.spatial_merge_size)

            return ImageInputSpec(
                num_image_tokens=0,
                image_size=arch.resize_factor,
                needs_mrope=True,
                variable=True,
                preprocess_example=prep_native,
                batch_vision=qwen_vl.batch_native,
                max_image_tokens=arch.max_merge_units,
                mrope_from_batch=mrope_fb,
            )

        size_h = arch.grid_h * arch.vision.patch_size
        if arch.grid_h != arch.grid_w:
            raise ValueError("pipelines take square fixed grids only")

        def prep(image: np.ndarray) -> np.ndarray:
            return qwen_vl.patchify(image, arch.vision)

        return ImageInputSpec(
            num_image_tokens=arch.num_image_tokens,
            image_size=size_h,
            preprocess=prep,
            needs_mrope=True,
        )

    if isinstance(arch, InternVLConfig):
        # dynamic tiling: <= 12 aspect-matched tiles + a thumbnail, padded
        # to a static tile count; the prompt carries num_image_tokens x
        # n_tiles context tokens
        from mllm_sparse_retrieval_tpu_torch.data.tiling import (
            dynamic_tile, pad_tiles)

        size = arch.vision.image_size
        tiles_max = arch.max_dynamic_tiles + 1  # + thumbnail

        def prep_ex(image: np.ndarray):
            tiles = dynamic_tile(image, tile_size=size,
                                 max_num=arch.max_dynamic_tiles)
            padded, _ = pad_tiles(tiles, tiles_max)
            return padded, arch.num_image_tokens * tiles.shape[0]

        return ImageInputSpec(
            num_image_tokens=0,
            image_size=size,
            variable=True,
            preprocess_example=prep_ex,
            batch_vision=lambda items: np.stack(items),
            max_image_tokens=arch.num_image_tokens * tiles_max,
        )

    if arch.anyres:
        # LLaVA-NeXT anyres: grid-pinpoint tiles + base, host-made feature
        # gather map
        size = arch.vision.image_size
        pps = arch.patches_per_side
        mt, mtok = arch.max_tiles, arch.max_image_tokens

        def prep_anyres(image: np.ndarray):
            a = A.preprocess_anyres(image, arch.grid_pinpoints, size, pps,
                                    mt, mtok)
            return ({"pixels": a.pixels, "feature_index": a.feature_index},
                    a.n_tokens)

        def batch_anyres(items):
            return {"pixels": np.stack([i["pixels"] for i in items]),
                    "feature_index": np.stack([i["feature_index"]
                                               for i in items])}

        return ImageInputSpec(
            num_image_tokens=0,
            image_size=size,
            variable=True,
            preprocess_example=prep_anyres,
            batch_vision=batch_anyres,
            max_image_tokens=mtok,
        )
    # fixed-grid LLaVA families: pixels pass through
    return ImageInputSpec(
        num_image_tokens=arch.num_image_tokens,
        image_size=arch.vision.image_size,
        preprocess=lambda image: image,
    )


def mrope_ids_for_batch(arch, input_ids: np.ndarray,
                        attention_mask: np.ndarray) -> Optional[np.ndarray]:
    """``[3, B, T]`` M-RoPE ids for fixed-grid Qwen image batches; None for
    the other families."""
    if not isinstance(arch, QwenVLConfig):
        return None
    return qwen_vl.mrope_position_ids(
        np.asarray(input_ids), np.asarray(attention_mask),
        arch.image_token_id, (1, arch.grid_h, arch.grid_w),
        arch.vision.spatial_merge_size)
