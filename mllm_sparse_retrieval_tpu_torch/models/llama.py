"""Decoder LM: Llama-family architecture (RMSNorm, RoPE, GQA, SwiGLU).

The language backbone of the LLaVA families, with the dense SwiGLU FFN and
optional LoRA adapters on its seven projections. Parameters are a dict in
the JAX package's tree layout (``embed``, ``blocks[i]``, ``final_norm``,
``lm_head``); norms and softmax run in f32, matmuls in the weights' dtype.
As in the JAX package, the LM head is not applied over the sequence: the
sparse head needs logits at one position per sample only (models/reps.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

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
    # M-RoPE (Qwen2.5-VL): per-frequency-band section sizes over head_dim/2
    # for the (temporal, height, width) position components; None =
    # standard RoPE
    mrope_section: Optional[Tuple[int, ...]] = None
    # the JAX package's mixture-of-experts FFN field, kept so that an
    # ``arch.json`` manifest has the same keys in both packages; it is not
    # ported, so only None is accepted
    moe: None = None

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                "mixture-of-experts backbones are not ported (ROADMAP "
                "Queue 1 #9: parallel/ep.py)")

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


def _block(x, p, cfg: LlamaConfig, mask, cos, sin, lora=None,
           flash_mask=None, lora_seed=None, *, lora_dropout: float = 0.0):
    """One decoder block; ``flash_mask`` (the ``[B, T]`` padding mask) takes
    the flash kernel instead of ``attention`` over the ``[B, 1, T, T]``
    ``mask``. ``lora`` is the block's adapter dict; with ``lora_seed`` and
    ``lora_dropout > 0`` each LoRA call site draws its dropout mask from a
    fresh generator seeded with ``fold_seed(lora_seed, site)``, sites in the
    JAX order q, k, v, o, gate, up, down: a pure function of integers, so a
    recompute under ``remat`` draws the same masks."""
    b, t, _ = x.shape
    dh = cfg.head_dim
    site = [0]

    def ld(y, name):
        gen = None
        if lora_seed is not None and lora_dropout > 0.0:
            gen = torch.Generator(device=y.device).manual_seed(
                L.fold_seed(lora_seed, site[0]))
        site[0] += 1
        return L.dense(y, p[name], lora.get(name) if lora else None, gen,
                       lora_dropout)

    y = L.rmsnorm(x, p["attn_norm"], cfg.rms_eps)
    q = ld(y, "q").view(b, t, cfg.num_heads, dh)
    k = ld(y, "k").view(b, t, cfg.num_kv_heads, dh)
    v = ld(y, "v").view(b, t, cfg.num_kv_heads, dh)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    if flash_mask is not None:
        with record_function("attention"):
            attn = L.flash_causal_attention(q, k, v, flash_mask)
    else:
        attn = L.attention(q, k, v, mask)
    attn = attn.reshape(b, t, cfg.num_heads * dh)
    x = x + ld(attn, "o")
    y = L.rmsnorm(x, p["mlp_norm"], cfg.rms_eps)
    gated = F.silu(ld(y, "gate")) * ld(y, "up")
    return x + ld(gated, "down")


def rope_tables(cfg: LlamaConfig, seq_len: int,
                position_ids: Optional[torch.Tensor] = None, device="cuda"):
    """cos/sin tables: ``[T, head_dim/2]`` for standard RoPE over
    ``arange(seq_len)``, ``[B, T, head_dim/2]`` for explicit ``[B, T]`` or
    multimodal ``[3, B, T]`` position ids.

    M-RoPE (HF ``apply_multimodal_rotary_pos_emb``): frequency band ``d``
    takes the position component ``section_of(d)``, the temporal, height
    and width sections of ``mrope_section`` over head_dim/2. Equal
    components reduce to 1-D RoPE."""
    if position_ids is None:
        return L.rope_frequencies(cfg.head_dim, seq_len, cfg.rope_theta,
                                  device=device)
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, cfg.head_dim, 2, dtype=torch.float32,
                     device=device) / cfg.head_dim))
    pos = position_ids.to(device=device, dtype=torch.float32)
    if pos.dim() == 3:
        if cfg.mrope_section is None:
            raise ValueError("3-D position ids need cfg.mrope_section")
        if sum(cfg.mrope_section) != cfg.head_dim // 2:
            raise ValueError(f"mrope_section {cfg.mrope_section} must sum "
                             f"to head_dim/2 = {cfg.head_dim // 2}")
        sec_map = torch.repeat_interleave(
            torch.arange(len(cfg.mrope_section), device=device),
            torch.tensor(cfg.mrope_section, device=device))
        # [3, B, T] -> [B, T, hd/2], the component of each band
        freqs = pos[sec_map].permute(1, 2, 0) * inv
    else:
        freqs = pos[:, :, None] * inv
    return torch.cos(freqs), torch.sin(freqs)


def apply(params: Dict, inputs_embeds: torch.Tensor,
          attention_mask: torch.Tensor, cfg: LlamaConfig,
          lora: Optional[Dict] = None,
          position_ids: Optional[torch.Tensor] = None, remat: bool = False,
          allow_flash: bool = True, lora_seed: Optional[int] = None,
          lora_dropout: float = 0.0) -> torch.Tensor:
    """Run the decoder stack; returns final-norm hidden states
    ``[B, T, H]``. Long sequences (anyres and tiled image prompts) take the
    flash kernels when ``layers.flash_attention_eligible`` holds and never
    build the ``[B, 1, T, T]`` mask; ``allow_flash=False`` forces the plain
    masked attention. ``position_ids``: ``[B, T]`` or ``[3, B, T]``
    (M-RoPE) positions; None is ``arange(T)`` for every row.

    ``lora``: the text adapter tree ``{"blocks": [...]}``. ``remat=True``
    checkpoints each block (``torch.utils.checkpoint``, non-reentrant):
    activations are recomputed in the backward pass. ``lora_seed`` +
    ``lora_dropout`` enable train-time dropout on the LoRA paths, block
    ``i`` seeded with ``fold_seed(lora_seed, i)``. Differentiable; serving
    callers run it under ``torch.inference_mode()``."""
    t = inputs_embeds.shape[1]
    cos, sin = rope_tables(cfg, t, position_ids,
                           device=inputs_embeds.device)
    use_flash = allow_flash and L.flash_attention_eligible(
        t, cfg.head_dim, inputs_embeds.device)
    flash_mask = attention_mask if use_flash else None
    mask = None if use_flash else L.causal_padding_mask(attention_mask)
    dropout_on = lora_seed is not None and lora_dropout > 0.0 \
        and lora is not None
    x = inputs_embeds
    for i, blk in enumerate(params["blocks"]):
        blora = None
        if lora is not None and "blocks" in lora and lora["blocks"][i]:
            blora = lora["blocks"][i]
        bseed = L.fold_seed(lora_seed, i) if dropout_on else None
        args = (x, blk, cfg, mask, cos, sin, blora, flash_mask, bseed)
        drop = lora_dropout if dropout_on else 0.0
        if remat:
            x = checkpoint(_block, *args, lora_dropout=drop,
                           use_reentrant=False)
        else:
            x = _block(*args, lora_dropout=drop)
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

