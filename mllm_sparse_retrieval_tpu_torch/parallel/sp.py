"""Sequence parallelism: ring attention over the model axis (the JAX
package's ``parallel/sp.py``).

The sequence of each data shard splits into contiguous chunks over the
mesh's model axis, chunk ``j`` on ``devices[i, j]``. Every per-token op of a
decoder block (norms, projections, SwiGLU, RoPE) runs on its chunk's
device; attention is a ring: each chunk scores its queries against the KV
chunk it currently holds, accumulates flash-style (running max,
normaliser and weighted values, in f32, with the f32-min additive masks of
``layers.attention``) and takes the next chunk, ``n`` steps in all. The
result equals ``layers.attention`` on the whole sequence, all-masked rows
included, and is differentiable.

One process drives the chunks: each runs ``llama._block`` in its own
thread, with the ring as the block's attention hook (``attn_impl``); the
chunks of a data shard meet at a barrier to hand each other their K and V,
as the JAX program's ``ppermute`` does on the mesh. The parameters (and
LoRA adapters) are read by every chunk through ``.to(device)``, so their
gradients sum onto the caller's tensors. This is the JAX package's
``shard_map`` + ``lax.scan`` ring, not a kernel: the TPU package's ring is
jnp, and so is this one.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence

import torch

from mllm_sparse_retrieval_tpu_torch.models.quantization import tree_to
from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh)


def _ring_chunk(my: int, q: torch.Tensor, ks: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                scale: Optional[float] = None) -> torch.Tensor:
    """Attention of query chunk ``my`` (``[B, Tl, Hq, Dh]``) over the ring
    of KV chunks ``ks`` / ``vs`` (``[B, Tl, Hkv, Dh]`` each, GQA: Hq a
    multiple of Hkv) with their ``[B, Tl]`` padding masks, visited in the
    ring's order ``my, my - 1, ...``; causal over the global positions."""
    n = len(ks)
    b, tl, hq, dh = q.shape
    dev = q.device
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    neg = torch.finfo(torch.float32).min
    qf = q.float()
    rows = torch.arange(tl, device=dev)
    acc_o = torch.zeros((b, hq, tl, dh), dtype=torch.float32, device=dev)
    acc_m = torch.full((b, hq, tl), neg, dtype=torch.float32, device=dev)
    acc_l = torch.zeros((b, hq, tl), dtype=torch.float32, device=dev)
    for s in range(n):
        kvid = (my - s) % n
        k, v = ks[kvid].to(dev), vs[kvid].to(dev)
        if k.shape[2] != hq:
            rep = hq // k.shape[2]
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        scores = torch.einsum("bthd,bshd->bhts", qf, k.float()) * scale
        causal = (kvid * tl + rows)[None, :] <= (my * tl + rows)[:, None]
        allow = causal[None, None] & masks[kvid].to(dev).bool()[
            :, None, None, :]
        scores = torch.where(allow, scores, torch.full_like(scores, neg))
        new_m = torch.maximum(acc_m, scores.amax(dim=-1))
        p = torch.exp(scores - new_m[..., None])
        alpha = torch.exp(acc_m - new_m)
        acc_l = acc_l * alpha + p.sum(dim=-1)
        acc_o = acc_o * alpha[..., None] + torch.einsum(
            "bhts,bshd->bhtd", p, v.float())
        acc_m = new_m
    out = acc_o / torch.clamp(acc_l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor],
                   kv_masks: Sequence[torch.Tensor], *,
                   scale: Optional[float] = None) -> List[torch.Tensor]:
    """Causal + padding attention of a sequence held as ``n`` contiguous
    chunks: ``qs[j]`` ``[B, Tl, Hq, Dh]``, ``ks[j]`` / ``vs[j]`` ``[B, Tl,
    Hkv, Dh]`` and ``kv_masks[j]`` ``[B, Tl]`` on chunk ``j``'s device.
    Returns each chunk's ``[B, Tl, Hq, Dh]`` output on its device: together,
    ``layers.attention`` with ``causal_padding_mask`` over the whole
    sequence."""
    return [_ring_chunk(j, q, ks, vs, kv_masks, scale)
            for j, q in enumerate(qs)]


class _Ring:
    """The meeting point of one data shard's chunks within a block."""

    def __init__(self, masks: List[torch.Tensor]):
        self.masks = masks
        self.kv: List = [None] * len(masks)
        self.barrier = threading.Barrier(len(masks))

    def attend(self, j: int, q, k, v):
        self.kv[j] = (k, v)
        self.barrier.wait()          # every chunk's K and V are in
        out = _ring_chunk(j, q, [kv[0] for kv in self.kv],
                          [kv[1] for kv in self.kv], self.masks)
        self.barrier.wait()          # every chunk has read them
        return out


def apply_sequence_parallel(
    params: Dict,
    inputs_embeds: torch.Tensor,     # [B, T, H]
    attention_mask: torch.Tensor,    # [B, T]
    cfg,                             # models.llama.LlamaConfig
    mesh: Mesh,
    lora: Optional[Dict] = None,
    position_ids: Optional[torch.Tensor] = None,  # [B, T] or [3, B, T]
) -> torch.Tensor:
    """``models.llama.apply`` with the sequence split over the model axis
    (and the batch over the data axis when it divides): final-norm hidden
    states ``[B, T, H]`` on ``inputs_embeds``' device. A decoder with MoE
    blocks and a sequence length the model axis does not divide raise
    ``ValueError``, as in the JAX package. ``position_ids`` follow
    ``llama.apply``'s contract; per-sample RoPE tables split like the
    activations."""
    from mllm_sparse_retrieval_tpu_torch.models import layers as L
    from mllm_sparse_retrieval_tpu_torch.models import llama

    if cfg.moe is not None:
        raise ValueError("sequence parallelism supports dense-FFN decoders "
                         "only; MoE blocks return (x, aux) — compose "
                         "parallel/ep.py with dp x tp instead")
    b, t, _ = inputs_embeds.shape
    n_sp = mesh.shape[MODEL_AXIS]
    if t % n_sp != 0:
        raise ValueError(f"seq len {t} not divisible by model axis {n_sp}")
    n_data = mesh.shape[DATA_AXIS]
    nb = n_data if n_data > 1 and b % n_data == 0 else 1
    bs, tl = b // nb, t // n_sp
    home = inputs_embeds.device
    cos, sin = llama.rope_tables(cfg, t, position_ids, device=home)
    has_lora = lora is not None and lora.get("blocks")
    grad_on = torch.is_grad_enabled()
    rings = [_Ring([attention_mask[i * bs:(i + 1) * bs,
                                   j * tl:(j + 1) * tl].to(mesh.devices[i, j])
                    for j in range(n_sp)]) for i in range(nb)]
    outs = [[None] * n_sp for _ in range(nb)]
    errors: List[BaseException] = []

    def chunk(i: int, j: int) -> None:
        dev = mesh.devices[i, j]
        rb, rt = slice(i * bs, (i + 1) * bs), slice(j * tl, (j + 1) * tl)
        try:
            with torch.set_grad_enabled(grad_on):
                x = inputs_embeds[rb, rt].to(dev)
                c, s = (cos[rt], sin[rt]) if cos.dim() == 2 else \
                    (cos[rb, rt], sin[rb, rt])
                c, s = c.to(dev), s.to(dev)
                p = tree_to(params, dev)
                lp = tree_to(lora, dev) if has_lora else None
                for k, blk in enumerate(p["blocks"]):
                    blora = lp["blocks"][k] if has_lora else None
                    x = llama._block(
                        x, blk, cfg, None, c, s, blora or None,
                        attn_impl=lambda q_, k_, v_: rings[i].attend(
                            j, q_, k_, v_))
                outs[i][j] = L.rmsnorm(x, p["final_norm"], cfg.rms_eps)
        except BaseException as e:       # noqa: BLE001 - re-raised below
            errors.append(e)
            for r in rings:
                r.barrier.abort()

    threads = [threading.Thread(target=chunk, args=(i, j), daemon=True)
               for i in range(nb) for j in range(n_sp)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        first = [e for e in errors
                 if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or errors)[0]
    return torch.cat([torch.cat([o.to(home) for o in row], dim=1)
                      for row in outs], dim=0)
