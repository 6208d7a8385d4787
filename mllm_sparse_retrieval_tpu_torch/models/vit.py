"""Vision tower: CLIP-style ViT (the JAX package's ``models/vit.py``).

Patch embedding is reshape + matmul (a convolution whose stride equals its
kernel is a patchwise matmul), so no cuDNN convolution and no TF32 question
arises. Blocks are pre-LN with GELU-family MLPs; the features are the
hidden states of ``feature_layer`` with the CLS token dropped, LLaVA's
``vision_feature_layer=-2`` / ``'default'`` select. Attention is the plain
``layers.attention`` with an all-true mask (T = 577 at 336 px: no kernel).

CLIP's tower has a CLS token and ``quick_gelu``; ``use_cls_token=False``
builds a tower without one (no CLS row in ``pos_embed``, nothing to drop),
and any other ``act`` is the tanh-approximate GELU, as the JAX package's
``_act`` computes it, whatever the name (HF's ``gelu`` is erf-exact and
``silu`` is no GELU: the port keeps the JAX package's choice).
``mlp_ratio`` comes from a checkpoint's ``config.json``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from mllm_sparse_retrieval_tpu_torch.models import layers as L


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    feature_layer: int = -2       # hidden layer used as image features
    use_cls_token: bool = True
    act: str = "quick_gelu"       # CLIP; any other name: tanh-approx GELU

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)


def init_params(cfg: ViTConfig, generator: torch.Generator, device="cuda",
                dtype=torch.bfloat16) -> Dict:
    """Random weights drawn on ``device`` with the JAX package's scaling
    (dense N(0, 1/fan_in), position and CLS embeddings N(0, 0.02²), norms
    scale 1 / bias 0)."""
    device = torch.device(device)

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=dtype)
        return w.mul_(scale)

    def dense_init(fan_in, fan_out):
        return {"w": normal((fan_in, fan_out), 1.0 / math.sqrt(fan_in))}

    def ln_init(dim):
        return {"scale": torch.ones(dim, device=device, dtype=dtype),
                "bias": torch.zeros(dim, device=device, dtype=dtype)}

    h, m = cfg.hidden_size, cfg.hidden_size * cfg.mlp_ratio
    params = {
        "patch_embed": dense_init(cfg.patch_size * cfg.patch_size * 3, h),
        "pos_embed": normal((cfg.seq_len, h), 0.02),
        "pre_ln": ln_init(h),
        "blocks": [],
    }
    if cfg.use_cls_token:
        params["cls_token"] = normal((h,), 0.02)
    for _ in range(cfg.num_layers):
        params["blocks"].append({
            "ln1": ln_init(h), "qkv": dense_init(h, 3 * h),
            "out": dense_init(h, h), "ln2": ln_init(h),
            "fc1": dense_init(h, m), "fc2": dense_init(m, h)})
    return params


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """``[B, H, W, 3] -> [B, P, patch*patch*3]`` without convolution."""
    b, h, w, c = pixel_values.shape
    gh, gw = h // patch, w // patch
    x = pixel_values.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, p, p, c]
    return x.reshape(b, gh * gw, patch * patch * c)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="tanh")


def _block(x, p, num_heads: int, lora: Optional[Dict] = None,
           act: str = "quick_gelu"):
    b, t, h = x.shape
    dh = h // num_heads
    lget = (lambda name: lora.get(name) if lora else None)
    y = L.layernorm(x, p["ln1"])
    q, k, v = L.dense(y, p["qkv"], lget("qkv")).chunk(3, dim=-1)
    q = q.reshape(b, t, num_heads, dh)
    k = k.reshape(b, t, num_heads, dh)
    v = v.reshape(b, t, num_heads, dh)
    mask = torch.ones((b, 1, t, t), dtype=torch.bool, device=x.device)
    attn = L.attention(q, k, v, mask).reshape(b, t, h)
    x = x + L.dense(attn, p["out"], lget("out"))
    y = L.layernorm(x, p["ln2"])
    y = _act(L.dense(y, p["fc1"], lget("fc1")), act)
    return x + L.dense(y, p["fc2"], lget("fc2"))


def apply(params: Dict, pixel_values: torch.Tensor, cfg: ViTConfig,
          lora: Optional[Dict] = None) -> torch.Tensor:
    """Patch features ``[B, num_patches, hidden]`` from ``feature_layer``.

    ``pixel_values``: ``[B, H, W, 3]`` float, already normalised on the host.
    Every layer runs, as in the JAX package, though the last one's output is
    not read at ``feature_layer=-2``. ``lora``: the vision adapter tree
    ``{"blocks": [...]}`` (no dropout, as in the JAX package).
    """
    x = patchify(pixel_values.to(params["patch_embed"]["w"].dtype),
                 cfg.patch_size)
    x = L.dense(x, params["patch_embed"])
    if cfg.use_cls_token:
        cls = params["cls_token"].expand(x.shape[0], 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"][None]
    x = L.layernorm(x, params["pre_ln"])
    keep = range(len(params["blocks"]))[cfg.feature_layer]
    for i, blk in enumerate(params["blocks"]):
        blora = None
        if lora is not None and "blocks" in lora and lora["blocks"][i]:
            blora = lora["blocks"][i]
        x = _block(x, blk, cfg.num_heads, blora, act=cfg.act)
        if i == keep:
            feats = x
    # drop CLS: LLaVA 'default' feature select
    return feats[:, 1:] if cfg.use_cls_token else feats
