"""InternVL2.5 family: InternViT tower + pixel shuffle + projector + decoder
(the JAX package's ``models/internvl.py``).

- timm-style ViT: patch embedding as a matmul (with bias), CLS token,
  absolute position embeddings, pre-norm blocks with layer scale
  (``lambda1`` / ``lambda2``) and optional QK-norm (RMSNorm over the full
  embed dim before the head split), LayerNorm or RMSNorm;
- pixel-shuffle 2x downsample of the patch grid (channels x4);
- projector: LayerNorm -> linear -> GELU -> linear;
- decoder: ``models/llama.py`` with a Qwen2-style backbone (``qkv_bias``).
  Image prompts of 13 tiles (3,328 image tokens, padded to 3,584) take the
  flash kernel there.

Dynamic tiling lives in ``data/tiling.py``; each tile runs through the tower
independently (tiles are batch entries). The tower's attention is the plain
``layers.attention`` over an all-true mask, chunked over the tiles
(``layers.attention_chunked``): 1,025 tokens a tile, no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.models import llama
from mllm_sparse_retrieval_tpu_torch.models import reps as R
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import (
    splice_image_embeddings)
from mllm_sparse_retrieval_tpu_torch.models.vit import patchify


@dataclass(frozen=True)
class InternViTConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 448
    patch_size: int = 14
    norm_type: str = "layer_norm"       # 'layer_norm' | 'rms_norm'
    use_qk_norm: bool = False
    layer_scale_init: float = 0.1
    attention_bias: bool = True
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class InternVLConfig:
    vision: InternViTConfig = field(default_factory=InternViTConfig)
    text: LlamaConfig = field(default_factory=LlamaConfig)
    image_token_id: int = 151667
    downsample_ratio: float = 0.5
    # dynamic tiling budget (max_num=12 + a thumbnail); pipelines pad to
    # ``max_dynamic_tiles + 1`` tiles with zero tiles
    max_dynamic_tiles: int = 12

    @property
    def num_image_tokens(self) -> int:
        """Context tokens per TILE."""
        grid = self.vision.image_size // self.vision.patch_size
        return int(grid * self.downsample_ratio) ** 2


def _norm(x, p, cfg: InternViTConfig):
    if cfg.norm_type == "rms_norm":
        return L.rmsnorm(x, p, cfg.layer_norm_eps)
    return L.layernorm(x, p, cfg.layer_norm_eps)


def init_vision_params(cfg: InternViTConfig, draw: L.ParamDraw) -> Dict:
    h, inter = cfg.hidden_size, cfg.intermediate_size
    norm = draw.rmsnorm if cfg.norm_type == "rms_norm" else draw.layernorm
    params = {
        "patch_embed": draw.dense(3 * cfg.patch_size ** 2, h, bias=True),
        "cls_token": draw.full((h,), 0.0),
        "pos_embed": draw.normal((cfg.num_patches + 1, h), 0.02),
        "blocks": [],
    }
    for _ in range(cfg.num_layers):
        blk = {
            "norm1": norm(h), "norm2": norm(h),
            "q": draw.dense(h, h, cfg.attention_bias),
            "k": draw.dense(h, h, cfg.attention_bias),
            "v": draw.dense(h, h, cfg.attention_bias),
            "proj": draw.dense(h, h, bias=True),
            "fc1": draw.dense(h, inter, bias=True),
            "fc2": draw.dense(inter, h, bias=True),
            "lambda1": draw.full((h,), cfg.layer_scale_init),
            "lambda2": draw.full((h,), cfg.layer_scale_init),
        }
        if cfg.use_qk_norm:
            blk["q_norm"] = draw.rmsnorm(h)
            blk["k_norm"] = draw.rmsnorm(h)
        params["blocks"].append(blk)
    return params


def _vision_block(x, p, cfg: InternViTConfig, mask):
    b, s, h = x.shape
    nh, dh = cfg.num_heads, cfg.head_dim

    y = _norm(x, p["norm1"], cfg)
    q = L.dense(y, p["q"])
    k = L.dense(y, p["k"])
    v = L.dense(y, p["v"])
    if cfg.use_qk_norm:
        # QK-norm over the FULL embed dim, before the head split
        q = L.rmsnorm(q, p["q_norm"], 1e-6)
        k = L.rmsnorm(k, p["k_norm"], 1e-6)
    attn = L.attention_chunked(q.reshape(b, s, nh, dh),
                               k.reshape(b, s, nh, dh),
                               v.reshape(b, s, nh, dh), mask)
    x = x + L.dense(attn.reshape(b, s, h), p["proj"]) * p["lambda1"]

    y = _norm(x, p["norm2"], cfg)
    y = F.gelu(L.dense(y, p["fc1"]), approximate="none")
    return x + L.dense(y, p["fc2"]) * p["lambda2"]


def vision_apply(params: Dict, pixel_values: torch.Tensor,
                 cfg: InternViTConfig) -> torch.Tensor:
    """``[B, H, W, 3]`` -> last hidden state ``[B, 1 + P, hidden]`` (CLS
    first)."""
    x = patchify(pixel_values.to(params["patch_embed"]["w"].dtype),
                 cfg.patch_size)
    x = L.dense(x, params["patch_embed"])
    cls = params["cls_token"].expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    s = x.shape[1]
    mask = torch.ones((1, 1, s, s), dtype=torch.bool, device=x.device)
    for blk in params["blocks"]:
        x = _vision_block(x, blk, cfg, mask)
    return x


def pixel_shuffle(features: torch.Tensor, scale: float) -> torch.Tensor:
    """``[B, W, H, C] -> [B, W*s, H*s, C/s^2]``, HF InternVL's convention
    (axis swaps included)."""
    b, w, h, c = features.shape
    features = features.reshape(b, w, int(h * scale), int(c / scale))
    features = features.permute(0, 2, 1, 3)
    features = features.reshape(b, int(h * scale), int(w * scale),
                                int(c / (scale * scale)))
    return features.permute(0, 2, 1, 3)


def image_features(params: Dict, pixel_values: torch.Tensor,
                   cfg: InternVLConfig) -> torch.Tensor:
    """Vision tower -> drop CLS -> pixel shuffle -> projector:
    ``[B, num_image_tokens, text_hidden]``."""
    feats = vision_apply(params["vision"], pixel_values, cfg.vision)[:, 1:]
    b, s, c = feats.shape
    grid = int(s ** 0.5)
    feats = pixel_shuffle(feats.reshape(b, grid, grid, c),
                          cfg.downsample_ratio)
    feats = feats.reshape(b, -1, feats.shape[-1])

    p = params["projector"]
    y = L.layernorm(feats, p["ln"])
    y = F.gelu(L.dense(y, p["fc1"]), approximate="none")
    return L.dense(y, p["fc2"])


def init_params(cfg: InternVLConfig, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> Dict:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live there): InternViT, the projector and the text tower, with the JAX
    package's scaling (the draws differ from its own)."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, weights on "
                         f"{device}")
    draw = L.ParamDraw(generator, device, dtype)
    shuffle_dim = int(cfg.vision.hidden_size / cfg.downsample_ratio ** 2)
    th = cfg.text.hidden_size
    return {
        "vision": init_vision_params(cfg.vision, draw),
        "projector": {"ln": draw.layernorm(shuffle_dim),
                      "fc1": draw.dense(shuffle_dim, th, bias=True),
                      "fc2": draw.dense(th, th, bias=True)},
        "text": llama.init_params(cfg.text, generator, device, dtype),
    }


def encode(params: Dict, cfg: InternVLConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           pixel_values: Optional[torch.Tensor] = None,
           reps_loc: RepsLoc = RepsLoc.BEFORE_PAD,
           lora: Optional[Dict] = None, remat: bool = False,
           allow_flash: bool = True, lora_seed: Optional[int] = None,
           lora_dropout: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sparse_weights [B, V] f32, dense_embs [B, H])``.

    ``pixel_values``: ``[B, S, S, 3]`` (one tile an image) or
    ``[B, max_tiles, S, S, 3]`` (dynamic tiling): every tile's features in
    tile order; zero padding tiles trail and are never spliced, since the
    prompt carries ``num_image_tokens`` x the valid tiles. The ``vision``,
    ``tower`` and ``lm_head`` ranges name the stages in a profiler trace."""
    lget = (lambda name: lora.get(name) if lora else None)
    embeds = llama.embed_tokens(params["text"], input_ids)
    if pixel_values is not None:
        with record_function("vision"):
            if pixel_values.dim() == 5:
                b, mt = pixel_values.shape[:2]
                feats = image_features(
                    params, pixel_values.reshape((b * mt,)
                                                 + pixel_values.shape[2:]),
                    cfg)
                feats = feats.reshape(b, mt * feats.shape[1],
                                      feats.shape[2])
            else:
                feats = image_features(params, pixel_values, cfg)
            embeds = splice_image_embeddings(
                embeds, feats.to(embeds.dtype),
                input_ids == cfg.image_token_id)
    with record_function("tower"):
        hidden = llama.apply(params["text"], embeds, attention_mask,
                             cfg.text, lget("text"), remat=remat,
                             allow_flash=allow_flash, lora_seed=lora_seed,
                             lora_dropout=lora_dropout)
    with record_function("lm_head"):
        head = llama.lm_head_weight(params["text"], cfg.text)
        return R.extract_reps(hidden, attention_mask, head, reps_loc)
