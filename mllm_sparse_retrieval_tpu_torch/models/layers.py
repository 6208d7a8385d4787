"""Shared building blocks on tensors: dense (+LoRA), norms, RoPE, attention,
masks.

Parameters are plain dicts of tensors in the JAX package's layout (dense
weights ``[in, out]``, so ``y = x @ w``), which keeps weights converted from
the JAX tree comparable one to one. LoRA is an optional parallel dict of
adapters, as in the JAX package, so adapter-only training is a choice of
which leaves get gradients. Long prompts (anyres image queries) take the
fused causal attention of ``ops/flash_attention.py``, whose CUDA kernels
replace the JAX package's Pallas flash kernel, forward and backward.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA


def dense(x: torch.Tensor, p: Dict[str, torch.Tensor],
          lora: Optional[Dict[str, torch.Tensor]] = None,
          lora_generator: Optional[torch.Generator] = None,
          lora_dropout: float = 0.0) -> torch.Tensor:
    """``x @ w (+ LoRA low-rank path) (+ bias)``, as the JAX package computes
    it.

    The LoRA path is factored, ``((x @ a) @ b) * scale``, never a
    materialised delta-W. ``lora_generator`` + ``lora_dropout > 0`` apply
    train-time dropout to the adapter input only (``keep / (1 - p)``); the
    base path is untouched, and inference passes no generator.

    dtype rule (a deviation from the JAX package): the adapter path runs in
    the adapters' dtype and its output is cast to the base output's dtype
    before the sum. The JAX package promotes instead, so f32 adapters over
    bf16 weights turn the residual stream f32 from the first adapted
    projection on; here it stays in the weights' dtype. Where both are f32
    (the CPU tests) the two agree exactly.
    """
    y = x @ p["w"]
    if lora is not None:
        a = lora["a"]
        xl = x.to(a.dtype)
        if lora_generator is not None and lora_dropout > 0.0:
            keep = torch.rand(x.shape, generator=lora_generator,
                              device=x.device) < 1.0 - lora_dropout
            xl = torch.where(keep, xl / (1.0 - lora_dropout),
                             torch.zeros((), dtype=a.dtype, device=x.device))
        y = y + (((xl @ a) @ lora["b"]) * lora["scale"]).to(y.dtype)
    if "b" in p:
        y = y + p["b"]
    return y


def lora_init(generator: torch.Generator, in_dim: int, out_dim: int,
              rank: int, alpha: float, dtype=torch.float32,
              device="cuda") -> Dict[str, torch.Tensor]:
    """Standard LoRA init: ``A ~ N(0, 1) / r``, ``B = 0`` (identity at step
    0), ``scale = alpha / r``."""
    a = torch.randn((in_dim, rank), generator=generator, dtype=dtype,
                    device=device) / rank
    return {"a": a,
            "b": torch.zeros((rank, out_dim), dtype=dtype, device=device),
            "scale": torch.tensor(alpha / rank, dtype=dtype, device=device)}


def merge_lora_into_dense(p: Dict[str, torch.Tensor],
                          lora: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """``w + (a @ b) * scale`` (PEFT's ``merge_and_unload``), cast to ``w``'s
    dtype (the dtype rule of ``dense``); other entries are kept."""
    merged = dict(p)
    delta = (lora["a"] @ lora["b"]) * lora["scale"]
    merged["w"] = p["w"] + delta.to(p["w"].dtype)
    return merged


class ParamDraw:
    """Random weights on one device from one generator, with the JAX
    package's scaling: dense N(0, 1/fan_in), biases 0, norms scale 1 /
    bias 0 (the vision towers of the chat-template families)."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.gen, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, scale):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=self.dtype).mul_(scale)

    def full(self, shape, value):
        return torch.full(shape, value, device=self.device, dtype=self.dtype)

    def dense(self, fan_in, fan_out, bias=False):
        p = {"w": self.normal((fan_in, fan_out), 1.0 / math.sqrt(fan_in))}
        if bias:
            p["b"] = self.full((fan_out,), 0.0)
        return p

    def rmsnorm(self, dim):
        return {"scale": self.full((dim,), 1.0)}

    def layernorm(self, dim):
        return {"scale": self.full((dim,), 1.0),
                "bias": self.full((dim,), 0.0)}


_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, data: int) -> int:
    """A new non-negative 63-bit seed from ``seed`` and ``data`` (the
    splitmix64 finaliser): the counterpart of ``jax.random.fold_in`` for
    integer seeds. LoRA dropout derives one seed per (step, micro-batch,
    tower, block, call site) with it, so every mask is a pure function of
    integers and a recompute (``remat``) draws the same mask."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


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
    """Rotate-half RoPE. x: ``[B, T, H, Dh]``; cos/sin: ``[T, Dh/2]``
    (shared positions) or ``[B, T, Dh/2]`` (per-sample positions: M-RoPE,
    the Qwen ViT's per-image tables)."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
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


ATTENTION_CHUNK_BYTES = 1 << 31


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor, *,
                      chunk_bytes: int = ATTENTION_CHUNK_BYTES
                      ) -> torch.Tensor:
    """``attention`` over slices of the batch whose f32 logits
    ``[b, Hq, T, S]`` take at most ``chunk_bytes`` (one item at least), so
    a vision tower's many tiles or long full-attention blocks never hold
    the whole batch's logits at once. ``mask`` has a batch dimension of 1
    (shared) or the batch's. The same numbers as ``attention`` on the whole
    batch: each item's attention is independent."""
    b, t, hq, _ = q.shape
    per_item = hq * t * k.shape[1] * 4
    step = max(1, chunk_bytes // per_item)
    if step >= b:
        return attention(q, k, v, mask)
    out = []
    for i in range(0, b, step):
        m = mask if mask.shape[0] == 1 else mask[i:i + step]
        out.append(attention(q[i:i + step], k[i:i + step], v[i:i + step], m))
    return torch.cat(out)


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
    """Causal attention through the flash kernels, differentiable
    (``ops.flash_attention.FlashCausalAttention``). Key ``s`` is admissible
    for query ``t`` iff ``s <= t`` and ``attention_mask[b, s]`` is set,
    which is ``attention`` + ``causal_padding_mask`` at every query that has
    a real key at or before it (a query with none gets 0 here, the uniform
    average of ``v`` there).

    q: ``[B, T, Hq, Dh]``; k/v: ``[B, T, Hkv, Dh]`` (GQA read in place);
    attention_mask: ``[B, T]``.
    """
    return FA.FlashCausalAttention.apply(q, k, v, attention_mask, scale)
