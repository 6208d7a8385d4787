"""The Qwen2-shaped decoder both configurations share, in float32.

Written from the Qwen2 / Qwen2.5-VL descriptions (Hugging Face's
``modeling_qwen2`` and ``modeling_qwen2_5_vl``): RMSNorm before attention
and MLP, q / k / v with biases, rotary positions by ``rotate_half``
(M-RoPE for Qwen2.5-VL: the frequency bands of ``mrope_section``, doubled,
take the temporal, height and width positions in turn), grouped-query
attention with a causal mask over real keys, a SwiGLU MLP, a final RMSNorm.
The representation is read at the last real position: the dense vector is
the final hidden state there, the sparse one ``log1p(relu)`` of the LM
head's logits there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from portbench.reference.quant import Linear


@dataclass(frozen=True)
class TextDims:
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    ffn: int
    vocab: int
    eps: float
    theta: float
    mrope: Optional[Tuple[int, ...]]
    tied: bool

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @classmethod
    def from_config(cls, config: dict) -> "TextDims":
        t = config.get("llm_config", config)
        sec = (t.get("rope_scaling") or {}).get("mrope_section")
        return cls(hidden=t["hidden_size"], layers=t["num_hidden_layers"],
                   heads=t["num_attention_heads"],
                   kv_heads=t["num_key_value_heads"],
                   ffn=t["intermediate_size"], vocab=t["vocab_size"],
                   eps=float(t["rms_norm_eps"]),
                   theta=float(t["rope_theta"]),
                   mrope=tuple(sec) if sec else None,
                   tied=bool(t["tie_word_embeddings"]))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rotary(pos: torch.Tensor, dims: TextDims):
    """cos / sin ``[B, T, head_dim]`` of positions ``[B, T]`` or, under
    M-RoPE, ``[3, B, T]`` (temporal, height, width)."""
    dh = dims.head_dim
    inv = 1.0 / (dims.theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                             device=pos.device) / dh))
    if pos.dim() == 2:
        pos = pos[None]
    freqs = pos.double()[..., None] * inv               # [C, B, T, dh/2]
    emb = torch.cat([freqs, freqs], dim=-1)             # [C, B, T, dh]
    if dims.mrope is None:
        emb = emb[0]
    else:
        parts = emb.split(list(dims.mrope) * 2, dim=-1)
        emb = torch.cat([p[i % 3] for i, p in enumerate(parts)], dim=-1)
    return emb.cos().float(), emb.sin().float()


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rope(x, cos, sin):
    return x * cos[:, :, None] + _rotate_half(x) * sin[:, :, None]


def attention(q, k, v, allowed):
    """q ``[B, T, H, D]``, k / v ``[B, S, Hkv, D]``, ``allowed`` ``[B, T,
    S]``: softmax(q k / sqrt(D)) v over the allowed keys, in float32."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) / q.shape[-1] ** 0.5
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)


def decoder(tp: dict, dims: TextDims, embeds: torch.Tensor,
            mask: torch.Tensor, pos: torch.Tensor, lin: Linear
            ) -> torch.Tensor:
    """Final-normed hidden states ``[B, T, H]`` (float32) of the decoder
    ``tp`` over ``embeds`` with padding ``mask`` ``[B, T]`` and positions
    ``pos``."""
    b, t, _ = embeds.shape
    dh = dims.head_dim
    cos, sin = rotary(pos, dims)
    real = mask.bool()
    allowed = torch.tril(torch.ones(t, t, dtype=torch.bool,
                                    device=embeds.device))[None] \
        & real[:, None, :]
    x = embeds.float()
    for blk in tp["blocks"]:
        y = rms_norm(x, blk["attn_norm"]["scale"], dims.eps)
        q = lin(y, blk["q"]["w"], blk["q"].get("b")).view(b, t, -1, dh)
        k = lin(y, blk["k"]["w"], blk["k"].get("b")).view(b, t, -1, dh)
        v = lin(y, blk["v"]["w"], blk["v"].get("b")).view(b, t, -1, dh)
        o = attention(_rope(q, cos, sin), _rope(k, cos, sin), v, allowed)
        x = x + lin(o.reshape(b, t, -1), blk["o"]["w"])
        y = rms_norm(x, blk["mlp_norm"]["scale"], dims.eps)
        g = lin(y, blk["gate"]["w"])
        x = x + lin(torch.nn.functional.silu(g) * lin(y, blk["up"]["w"]),
                    blk["down"]["w"])
    return rms_norm(x, tp["final_norm"]["scale"], dims.eps)


def head_weight(tp: dict, dims: TextDims) -> torch.Tensor:
    """``[H, V]``: the LM head, or the embedding's transpose when tied."""
    return tp["embed"].T if dims.tied else tp["lm_head"]["w"]


def reps(tp: dict, dims: TextDims, hidden: torch.Tensor,
         mask: torch.Tensor, lin: Linear):
    """(sparse ``[B, V]`` = log1p(relu(logits)), dense ``[B, H]``
    L2-normalised) at each row's last real position."""
    last = mask.long().sum(1) - 1
    h = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    logits = lin(h, head_weight(tp, dims))
    dense = h / h.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.log1p(torch.relu(logits)), dense


def text_positions(mask: torch.Tensor, dims: TextDims) -> torch.Tensor:
    """Positions of a text-only batch: 0, 1, ... along each row (all three
    M-RoPE components alike)."""
    b, t = mask.shape
    pos = torch.arange(t, device=mask.device)[None].expand(b, t)
    return pos if dims.mrope is None else pos[None].expand(3, b, t)
