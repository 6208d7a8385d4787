"""Model-agnostic encode dispatch (the JAX package's ``models/api.py``, for
the LLaVA families the port builds).

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
from mllm_sparse_retrieval_tpu_torch.models import mllm
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig


def encode_any(params, arch, input_ids, attention_mask, vision_input=None,
               reps_loc: RepsLoc = RepsLoc.BEFORE_PAD, lora=None,
               position_ids=None, remat: bool = False,
               allow_flash: bool = True, lora_seed: Optional[int] = None,
               lora_dropout: float = 0.0):
    """``(sparse [B, V], dense [B, H])``, in the JAX package's argument
    order. ``vision_input`` is a fixed-grid pixel tensor or the anyres dict
    (``mllm.forward_hidden``); ``position_ids`` (M-RoPE) belong to the
    Qwen2.5-VL family, and the LLaVA families ignore them, as in the JAX
    package. ``remat`` checkpoints the decoder blocks; ``lora_seed`` +
    ``lora_dropout`` enable train-time dropout on the decoder adapters
    (``models/llama.py``); inference callers pass neither."""
    if not isinstance(arch, MLLMConfig):
        raise NotImplementedError(
            f"{type(arch).__name__} is not ported yet (ROADMAP Queue 1 #6: "
            f"models/qwen_vl.py, models/internvl.py)")
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

    Variable families (``variable=True``, LLaVA-NeXT anyres): the token
    count depends on the original image size. ``preprocess_example`` maps a
    raw image ([H, W, 3] float in [0, 1] or uint8, not pre-resized) to
    ``(vision_item, n_tokens)`` with static per-example shapes;
    ``batch_vision`` stacks items into the model's vision input;
    ``max_image_tokens`` bounds n_tokens so callers can pad prompts to one
    fixed length.
    """

    num_image_tokens: int
    image_size: int                       # square pixel size (fixed families)
    preprocess: Optional[Callable] = None
    variable: bool = False
    preprocess_example: Optional[Callable] = None
    batch_vision: Optional[Callable] = None
    max_image_tokens: int = 0


def image_input_spec(arch) -> ImageInputSpec:
    if not isinstance(arch, MLLMConfig):
        raise NotImplementedError(
            f"image inputs of {type(arch).__name__} are not ported yet "
            f"(ROADMAP Queue 1 #6: models/qwen_vl.py, models/internvl.py, "
            f"data/tiling.py)")
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
