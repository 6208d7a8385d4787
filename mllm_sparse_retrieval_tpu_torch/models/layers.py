"""Shared building blocks on tensors: dense, norms, RoPE, attention, masks.

Parameters are plain dicts of tensors in the JAX package's layout (dense
weights ``[in, out]``, so ``y = x @ w``), which keeps weights converted from
the JAX tree comparable one to one. Long prompts (anyres image queries) take
the fused causal attention of ``ops/flash_attention.py``, whose CUDA kernel
replaces the JAX package's Pallas flash kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA


def dense(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``x @ w (+ bias)``."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(x: torch.Tensor, p: Dict[str, torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dtype)


def layernorm(x: torch.Tensor, p: Dict[str, torch.Tensor],
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 (biased variance) and cast back to the
    input dtype."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(dtype)


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device="cuda"):
    """cos/sin tables ``[max_len, head_dim/2]`` in f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x: ``[B, T, H, Dh]``; cos/sin: ``[T, Dh/2]``."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, *, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Batched multi-head attention with a boolean attend mask.

    q: ``[B, T, Hq, Dh]``, k/v: ``[B, S, Hkv, Dh]`` (GQA: Hq a multiple of
    Hkv), mask: broadcastable to ``[B, Hq, T, S]`` (True = attend). Logits
    and softmax in f32 whatever the compute dtype, as in the JAX package.
    """
    hq, dh = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if hq != hkv:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def causal_padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` padding mask -> ``[B, 1, T, T]`` causal + padding mask."""
    t = attention_mask.shape[1]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=attention_mask.device))
    pad = attention_mask.bool()[:, None, None, :]
    return causal[None, None] & pad


FLASH_MIN_SEQ = 1024  # below this the [T, T] logits tensor is cheap anyway


def flash_attention_eligible(seq_len: int, head_dim: int,
                             device: torch.device) -> bool:
    """Take the fused flash kernel when it pays and its tiling fits: long
    sequences (anyres image prompts reach ~3k tokens, where plain attention
    materialises a [B, H, T, T] f32 logits tensor per layer), the JAX
    package's 512-aligned lengths, tensors on a CUDA device. The JAX gate
    admits any multiple of 128 as head_dim; the CUDA kernel takes exactly
    128 (every ported family's width), so other widths stay on the plain
    route instead of reaching a kernel that refuses them."""
    return (torch.device(device).type == "cuda"
            and seq_len >= FLASH_MIN_SEQ
            and seq_len % 512 == 0
            and head_dim == FA.HEAD_DIM)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           attention_mask: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention through the flash kernel; padding is excluded as
    segment ids (pad 0, real 1), which matches ``attention`` +
    ``causal_padding_mask`` at every non-pad position.

    q: ``[B, T, Hq, Dh]``; k/v: ``[B, T, Hkv, Dh]`` (GQA read in place);
    attention_mask: ``[B, T]``.
    """
    return FA.flash_causal_attention(q, k, v, attention_mask, scale=scale)
