"""Decoder LM: Llama-family architecture (RMSNorm, RoPE, GQA, SwiGLU).

The language backbone of the LLaVA families, with the dense SwiGLU FFN.
Parameters are a dict in the JAX package's tree layout (``embed``,
``blocks[i]``, ``final_norm``, ``lm_head``); norms and softmax run in f32,
matmuls in the weights' dtype. As in the JAX package, the LM head is not
applied over the sequence: the sparse head needs logits at one position per
sample only (models/reps.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from mllm_sparse_retrieval_tpu_torch.models import layers as L


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    max_seq_len: int = 4096
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    qkv_bias: bool = False       # True for Qwen2-style backbones
    tie_lm_head: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> Dict:
    """Random weights drawn on ``device`` from ``generator`` (which must live
    on that device), with the JAX package's scaling: embeddings N(0, 0.02²),
    dense weights N(0, 1/fan_in), norm scales 1. The draws differ from the
    JAX package's (another generator); tests that compare the two convert
    the JAX weights instead (models/convert_jax.py)."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, weights on "
                         f"{device}")

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=dtype)
        return w.mul_(scale)

    def dense_init(fan_in, fan_out):
        return {"w": normal((fan_in, fan_out), 1.0 / math.sqrt(fan_in))}

    def norm_init(dim):
        return {"scale": torch.ones(dim, device=device, dtype=dtype)}

    h, dh = cfg.hidden_size, cfg.head_dim
    params = {"embed": normal((cfg.vocab_size, h), 0.02),
              "final_norm": norm_init(h), "blocks": []}
    if not cfg.tie_lm_head:
        params["lm_head"] = dense_init(h, cfg.vocab_size)
    for _ in range(cfg.num_layers):
        blk = {
            "attn_norm": norm_init(h),
            "q": dense_init(h, cfg.num_heads * dh),
            "k": dense_init(h, cfg.num_kv_heads * dh),
            "v": dense_init(h, cfg.num_kv_heads * dh),
            "o": dense_init(cfg.num_heads * dh, h),
            "mlp_norm": norm_init(h),
            "gate": dense_init(h, cfg.intermediate_size),
            "up": dense_init(h, cfg.intermediate_size),
            "down": dense_init(cfg.intermediate_size, h),
        }
        if cfg.qkv_bias:
            for name, width in (("q", cfg.num_heads * dh),
                                ("k", cfg.num_kv_heads * dh),
                                ("v", cfg.num_kv_heads * dh)):
                blk[name]["b"] = torch.zeros(width, device=device,
                                             dtype=dtype)
        params["blocks"].append(blk)
    return params


def _block(x, p, cfg: LlamaConfig, mask, cos, sin, flash_mask=None):
    """One decoder block; ``flash_mask`` (the ``[B, T]`` padding mask) takes
    the flash kernel instead of ``attention`` over the ``[B, 1, T, T]``
    ``mask``."""
    b, t, _ = x.shape
    dh = cfg.head_dim
    y = L.rmsnorm(x, p["attn_norm"], cfg.rms_eps)
    q = L.dense(y, p["q"]).view(b, t, cfg.num_heads, dh)
    k = L.dense(y, p["k"]).view(b, t, cfg.num_kv_heads, dh)
    v = L.dense(y, p["v"]).view(b, t, cfg.num_kv_heads, dh)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    if flash_mask is not None:
        with record_function("attention"):
            attn = L.flash_causal_attention(q, k, v, flash_mask)
    else:
        attn = L.attention(q, k, v, mask)
    attn = attn.reshape(b, t, cfg.num_heads * dh)
    x = x + L.dense(attn, p["o"])
    y = L.rmsnorm(x, p["mlp_norm"], cfg.rms_eps)
    gated = F.silu(L.dense(y, p["gate"])) * L.dense(y, p["up"])
    return x + L.dense(gated, p["down"])


def rope_tables(cfg: LlamaConfig, seq_len: int, device="cuda"):
    """cos/sin tables ``[T, head_dim/2]`` for standard 1-D RoPE."""
    return L.rope_frequencies(cfg.head_dim, seq_len, cfg.rope_theta,
                              device=device)


@torch.no_grad()
def apply(params: Dict, inputs_embeds: torch.Tensor,
          attention_mask: torch.Tensor, cfg: LlamaConfig,
          allow_flash: bool = True) -> torch.Tensor:
    """Run the decoder stack; returns final-norm hidden states
    ``[B, T, H]``. Long sequences (anyres image prompts) take the flash
    kernel when ``layers.flash_attention_eligible`` holds and never build
    the ``[B, 1, T, T]`` mask; ``allow_flash=False`` forces the plain
    masked attention."""
    t = inputs_embeds.shape[1]
    cos, sin = rope_tables(cfg, t, device=inputs_embeds.device)
    use_flash = allow_flash and L.flash_attention_eligible(
        t, cfg.head_dim, inputs_embeds.device)
    flash_mask = attention_mask if use_flash else None
    mask = None if use_flash else L.causal_padding_mask(attention_mask)
    x = inputs_embeds
    for blk in params["blocks"]:
        x = _block(x, blk, cfg, mask, cos, sin, flash_mask)
    return L.rmsnorm(x, params["final_norm"], cfg.rms_eps)


def embed_tokens(params: Dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids]


def lm_head_weight(params: Dict, cfg: LlamaConfig) -> torch.Tensor:
    """``[H, V]`` head matrix (transposed embedding when tied)."""
    if cfg.tie_lm_head:
        return params["embed"].T
    return params["lm_head"]["w"]


def param_count(params: Dict) -> int:
    """Number of weights in a params dict (any nesting of dicts/lists)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return sum(param_count(v) for v in params)

