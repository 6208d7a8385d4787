"""LLaVA-style multimodal composition: vision tower -> projector -> decoder.

``<image>`` placeholder tokens in the prompt are replaced, position by
position, by projected ViT patch features, then the whole sequence runs
through the decoder. The splice is a static-shape cumsum-gather:

    img_slot[b, t] = (number of image tokens at positions <= t) - 1
    embeds[b, t]   = is_image[b, t] ? projected[b, img_slot[b, t]] : token_emb

LLaVA-NeXT anyres inputs (``models/anyres.py``) run every tile through the
ViT as one flat batch and gather their features, with the learned
``image_newline`` row, by a host-made index. Representations come from
``reps.extract_reps`` (last non-pad position; LM head at that position only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.models import anyres as A
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.models import llama, vit
from mllm_sparse_retrieval_tpu_torch.models import reps as R
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig


@dataclass(frozen=True)
class MLLMConfig:
    vision: ViTConfig = field(default_factory=ViTConfig)
    text: LlamaConfig = field(default_factory=LlamaConfig)
    image_token_id: int = 4
    projector_hidden: Optional[int] = None  # default: text hidden size
    # LLaVA-NeXT anyres multi-patch mode: image inputs are
    # {"pixels": [B, max_tiles, S, S, 3], "feature_index": [B, max_tokens]}
    # and params carry a learned ``image_newline`` embedding
    grid_pinpoints: Tuple[Tuple[int, int], ...] = ()

    @property
    def anyres(self) -> bool:
        return len(self.grid_pinpoints) > 0

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches

    @property
    def patches_per_side(self) -> int:
        return self.vision.image_size // self.vision.patch_size

    @property
    def max_tiles(self) -> int:
        return A.max_tiles(self.grid_pinpoints, self.vision.image_size)

    @property
    def max_image_tokens(self) -> int:
        return A.max_image_tokens(self.grid_pinpoints, self.vision.image_size,
                                  self.patches_per_side)


def init_params(cfg: MLLMConfig, generator: torch.Generator, device="cuda",
                dtype=torch.bfloat16) -> Dict:
    """Random weights drawn on ``device`` (see ``llama.init_params``): the
    ViT, the 2-layer projector, the text tower and, for anyres configs, the
    ``image_newline`` embedding N(0, 0.02²)."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, weights on "
                         f"{device}")
    ph = cfg.projector_hidden or cfg.text.hidden_size

    def dense_init(fan_in, fan_out):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=device, dtype=dtype)
        return {"w": w.mul_(fan_in ** -0.5)}

    params = {
        "vision": vit.init_params(cfg.vision, generator, device, dtype),
        "projector": {"fc1": dense_init(cfg.vision.hidden_size, ph),
                      "fc2": dense_init(ph, cfg.text.hidden_size)},
        "text": llama.init_params(cfg.text, generator, device, dtype),
    }
    if cfg.anyres:
        params["image_newline"] = torch.randn(
            (cfg.text.hidden_size,), generator=generator, device=device,
            dtype=dtype).mul_(0.02)
    return params


def project_image_features(params: Dict, feats: torch.Tensor,
                           lora: Optional[Dict] = None) -> torch.Tensor:
    """2-layer GELU MLP projector (exact-erf GELU, HF's default
    ``projector_hidden_act='gelu'``); ``lora`` is the projector's adapter
    dict (``fc1``, ``fc2``)."""
    lget = (lambda name: lora.get(name) if lora else None)
    x = L.dense(feats, params["projector"]["fc1"], lget("fc1"))
    x = F.gelu(x, approximate="none")
    return L.dense(x, params["projector"]["fc2"], lget("fc2"))


def splice_image_embeddings(token_embeds: torch.Tensor,
                            image_embeds: torch.Tensor,
                            is_image: torch.Tensor) -> torch.Tensor:
    """token_embeds ``[B, T, H]``, image_embeds ``[B, P, H]``, is_image
    ``[B, T]`` bool -> ``[B, T, H]`` with the image slots filled in order."""
    slots = torch.cumsum(is_image.long(), dim=1) - 1
    slots = slots.clamp(0, image_embeds.shape[1] - 1)
    gathered = torch.gather(
        image_embeds, 1,
        slots[:, :, None].expand(-1, -1, image_embeds.shape[-1]))
    return torch.where(is_image[:, :, None], gathered, token_embeds)


def anyres_image_features(params: Dict, cfg: MLLMConfig,
                          pixel_values: torch.Tensor,
                          feature_index: torch.Tensor,
                          lora: Optional[Dict] = None) -> torch.Tensor:
    """``[B, max_image_tokens, H]`` spliceable features for anyres inputs.

    All tiles run through the ViT as one flat batch (static shape; invalid
    tiles cost FLOPs but are never gathered), the per-image feature table
    gets the ``image_newline`` row appended, and the host-made gather map
    lays the features out in HF ``pack_image_features`` order. ``lora`` is
    the whole adapter tree (its ``vision`` and ``projector`` entries apply).
    """
    lget = (lambda name: lora.get(name) if lora else None)
    b, mt, s, _, c = pixel_values.shape
    feats = vit.apply(params["vision"], pixel_values.reshape(b * mt, s, s, c),
                      cfg.vision, lget("vision"))
    proj = project_image_features(params, feats, lget("projector"))
    ppt = proj.shape[1]
    table = proj.reshape(b, mt * ppt, proj.shape[-1])
    newline = params["image_newline"].to(table.dtype).expand(
        b, 1, table.shape[-1])
    table = torch.cat([table, newline], dim=1)          # [B, mt*ppt+1, H]
    idx = feature_index.long()[:, :, None].expand(-1, -1, table.shape[-1])
    return torch.gather(table, 1, idx)


def forward_hidden(params: Dict, cfg: MLLMConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor, pixel_values=None,
                   lora: Optional[Dict] = None, remat: bool = False,
                   allow_flash: bool = True, lora_seed: Optional[int] = None,
                   lora_dropout: float = 0.0) -> torch.Tensor:
    """Final-layer hidden states ``[B, T, H]`` for text or image+text inputs.

    ``pixel_values``: ``[B, H, W, 3]`` for fixed-grid families, or the
    anyres dict ``{"pixels": [B, mt, S, S, 3], "feature_index": [B, n]}``.
    ``lora_seed``/``lora_dropout`` apply to the decoder adapters;
    vision/projector adapters train without dropout, as in the JAX package.
    The ``vision`` range names the ViT and projector in a profiler trace.
    """
    lget = (lambda name: lora.get(name) if lora else None)
    embeds = llama.embed_tokens(params["text"], input_ids)
    if pixel_values is not None:
        with record_function("vision"):
            if isinstance(pixel_values, dict):
                img = anyres_image_features(params, cfg,
                                            pixel_values["pixels"],
                                            pixel_values["feature_index"],
                                            lora)
            else:
                feats = vit.apply(params["vision"], pixel_values, cfg.vision,
                                  lget("vision"))
                img = project_image_features(params, feats,
                                             lget("projector"))
            embeds = splice_image_embeddings(
                embeds, img.to(embeds.dtype), input_ids == cfg.image_token_id)
    with record_function("tower"):
        return llama.apply(params["text"], embeds, attention_mask, cfg.text,
                           lget("text"), remat=remat, allow_flash=allow_flash,
                           lora_seed=lora_seed, lora_dropout=lora_dropout)


def encode(params: Dict, cfg: MLLMConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor, pixel_values=None,
           reps_loc: RepsLoc = RepsLoc.BEFORE_PAD,
           lora: Optional[Dict] = None, remat: bool = False,
           allow_flash: bool = True, lora_seed: Optional[int] = None,
           lora_dropout: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sparse_weights [B, V] f32, dense_embs [B, H])`` for text or
    image+text inputs, in the JAX package's argument order (``pixel_values``
    as in ``forward_hidden``). Differentiable with respect to ``lora`` (and
    the params); serving callers run it under ``torch.inference_mode()``.
    The ``vision``, ``tower`` and ``lm_head`` ranges name the stages in a
    profiler trace."""
    hidden = forward_hidden(params, cfg, input_ids, attention_mask,
                            pixel_values, lora, remat=remat,
                            allow_flash=allow_flash, lora_seed=lora_seed,
                            lora_dropout=lora_dropout)
    with record_function("lm_head"):
        head = llama.lm_head_weight(params["text"], cfg.text)
        return R.extract_reps(hidden, attention_mask, head, reps_loc)
