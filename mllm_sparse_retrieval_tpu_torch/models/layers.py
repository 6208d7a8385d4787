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

from mllm_sparse_retrieval_tpu_torch.models.quantization import (
    QuantizedWeight, dequantize_weight)
from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    MODEL_AXIS, Sharded, as_tensor)
from mllm_sparse_retrieval_tpu_torch.tracing import span


def dense(x: torch.Tensor, p: Dict[str, torch.Tensor],
          lora: Optional[Dict[str, torch.Tensor]] = None,
          lora_generator: Optional[torch.Generator] = None,
          lora_dropout: float = 0.0, lora_rows=None) -> torch.Tensor:
    """``x @ w (+ LoRA low-rank path) (+ bias)``, as the JAX package computes
    it.

    The LoRA path is factored, ``((x @ a) @ b) * scale``, never a
    materialised delta-W. ``lora_generator`` + ``lora_dropout > 0`` apply
    train-time dropout to the adapter input only (``keep / (1 - p)``); the
    base path is untouched, and inference passes no generator.
    ``lora_rows=(offset, total)`` says that ``x`` holds rows ``offset :
    offset + len(x)`` of a batch of ``total`` rows split over a mesh: the
    mask is then those rows of the whole batch's draw, so a sharded step
    drops what the unsharded step drops (JAX's jit over a mesh gives its
    unsharded result).

    dtype rule (a deviation from the JAX package): the adapter path runs in
    the adapters' dtype and its output is cast to the base output's dtype
    before the sum. The JAX package promotes instead, so f32 adapters over
    bf16 weights turn the residual stream f32 from the first adapted
    projection on; here it stays in the weights' dtype. Where both are f32
    (the CPU tests) the two agree exactly.

    ``p["w"]`` may be a ``QuantizedWeight`` (k-bit base weights, QLoRA): it
    is dequantized per use into ``x``'s dtype, as in the JAX package, so
    one layer's weight at a time exists in the compute dtype. It never
    requires a gradient. It may be a ``parallel.mesh.Sharded``: split over
    the data axis (FSDP) it is gathered onto ``x``'s device here, per use
    (a recompute under remat gathers again); split over the model axis
    (tensor parallelism) it runs in the megatron form, each piece on its
    device: a column split computes each device's output columns and
    concatenates them, a row split multiplies each device's slice of the
    input and sums the partial products on ``x``'s device.
    """
    w = p["w"]
    if isinstance(w, Sharded) and w.axis == MODEL_AXIS:
        if w.dim == 1:
            y = torch.cat([(x.to(d) @ as_tensor(piece, d)).to(x.device)
                           for piece, d in zip(w.pieces, w.devices)], dim=-1)
        else:
            step = w.shape[0] // len(w.pieces)
            y = None
            for j, (piece, d) in enumerate(zip(w.pieces, w.devices)):
                part = (x[..., j * step:(j + 1) * step].to(d)
                        @ as_tensor(piece, d)).to(x.device)
                y = part if y is None else y + part
    else:
        if isinstance(w, Sharded):
            w = w.gather(x.device)
        elif isinstance(w, QuantizedWeight):
            w = dequantize_weight(w, x.dtype)
        y = x @ w
    if lora is not None:
        a = lora["a"]
        xl = x.to(a.dtype)
        if lora_generator is not None and lora_dropout > 0.0:
            if lora_rows is None:
                u = torch.rand(x.shape, generator=lora_generator,
                               device=x.device)
            else:
                offset, total = lora_rows
                u = torch.rand((total,) + tuple(x.shape[1:]),
                               generator=lora_generator,
                               device=x.device)[offset:offset + x.shape[0]]
            keep = u < 1.0 - lora_dropout
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
    dtype (the dtype rule of ``dense``); other entries are kept. A quantized
    base weight raises ``TypeError``, as in the JAX package."""
    if isinstance(p["w"], QuantizedWeight):
        raise TypeError(
            "cannot merge LoRA into a quantized base weight — keep the "
            "adapters separate (serve with lora=...) or dequantize_params "
            "first for an export-time merge")
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
    batch: each item's attention is independent. The vision towers are its
    only callers, so its ``vit_attention`` span is their attention."""
    b, t, hq, _ = q.shape
    per_item = hq * t * k.shape[1] * 4
    step = max(1, chunk_bytes // per_item)
    with span("vit_attention"):
        if step >= b:
            return attention(q, k, v, mask)
        out = []
        for i in range(0, b, step):
            m = mask if mask.shape[0] == 1 else mask[i:i + step]
            out.append(attention(q[i:i + step], k[i:i + step],
                                 v[i:i + step], m))
        return torch.cat(out)


def causal_padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` padding mask -> ``[B, 1, T, T]`` causal + padding mask."""
    t = attention_mask.shape[1]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=attention_mask.device))
    pad = attention_mask.bool()[:, None, None, :]
    return causal[None, None] & pad


def full_padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` padding mask -> ``[B, 1, T, T]`` bidirectional attend
    mask (query and key both real)."""
    pad = attention_mask.bool()
    return pad[:, None, :, None] & pad[:, None, None, :]


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
                           scale: Optional[float] = None,
                           mesh=None) -> torch.Tensor:
    """Causal attention through the flash kernels, differentiable
    (``ops.flash_attention.FlashCausalAttention``). Key ``s`` is admissible
    for query ``t`` iff ``s <= t`` and ``attention_mask[b, s]`` is set,
    which is ``attention`` + ``causal_padding_mask`` at every query that has
    a real key at or before it (a query with none gets 0 here, the uniform
    average of ``v`` there).

    q: ``[B, T, Hq, Dh]``; k/v: ``[B, T, Hkv, Dh]`` (GQA read in place);
    attention_mask: ``[B, T]``. ``mesh`` (a ``parallel.mesh.Mesh``) runs
    the kernel once per shard (``_sharded_flash``).
    """
    if mesh is not None:
        return _sharded_flash(mesh, q, k, v, attention_mask, scale)
    return FA.FlashCausalAttention.apply(q, k, v, attention_mask, scale)


def _sharded_flash(mesh, q, k, v, attention_mask, scale):
    """The flash kernel once per shard of ``mesh``: the batch splits over
    the data axis when it divides it, the kv heads (and their groups of q
    heads, contiguous under GQA) over the model axis when ``hkv`` divides
    it; an axis that does not split runs on its first device, as a
    replicated computation does once. Shard ``(i, j)`` runs on
    ``mesh.devices[i, j]``; its q / k / v slices are made contiguous
    there (a head slice is strided, and the kernel's TMA descriptors need
    dense rows), and the outputs are gathered back onto ``q``'s device.
    Attention is independent per (batch row, head), so no other
    communication is needed. Differentiable, as the copies and slices
    are."""
    from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
        DATA_AXIS, MODEL_AXIS)

    b, hq, hkv = q.shape[0], q.shape[2], k.shape[2]
    n_data, n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    nb = n_data if n_data > 1 and b % n_data == 0 else 1
    nh = n_model if n_model > 1 and hkv % n_model == 0 else 1
    bs, qs, ks = b // nb, hq // nh, hkv // nh
    rows = []
    for i in range(nb):
        heads = []
        for j in range(nh):
            dev = mesh.devices[i, j]
            rb = slice(i * bs, (i + 1) * bs)
            heads.append(FA.FlashCausalAttention.apply(
                q[rb, :, j * qs:(j + 1) * qs].to(dev).contiguous(),
                k[rb, :, j * ks:(j + 1) * ks].to(dev).contiguous(),
                v[rb, :, j * ks:(j + 1) * ks].to(dev).contiguous(),
                attention_mask[rb].to(dev), scale).to(q.device))
        rows.append(torch.cat(heads, dim=2))
    return torch.cat(rows, dim=0)
