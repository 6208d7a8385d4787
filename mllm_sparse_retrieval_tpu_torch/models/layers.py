"""Shared building blocks on tensors: dense, RMSNorm, RoPE, attention, masks.

Parameters are plain dicts of tensors in the JAX package's layout (dense
weights ``[in, out]``, so ``y = x @ w``), which keeps weights converted from
the JAX tree comparable one to one. The flash-attention path of the JAX
package (its long-prompt Pallas kernel) is not on the text-query path and
waits for the image-query slice.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


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
