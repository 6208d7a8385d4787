"""Contrastive LoRA training by definition, in float32.

A step: each pair's caption prompt and image prompt through the decoder
with LoRA on every linear map of every block (``y = x W + b + ((d(x) A) B)
s``, ``d`` the dropout of the adapter input, ``keep / (1 - p)``), the
dense reps at each prompt's last real position, the symmetric InfoNCE of
the L2-normalised reps at temperature ``tau``, the gradients of every
adapter leaf (``A``, ``B``, ``s``), clipping by their global norm, and
Adam with bias correction at a constant learning rate (``+ weight_decay *
x``, AdamW, where it is above 0). The vision tower is frozen: its
features carry no gradient.

The dropout masks are the port's rule, frozen here: the mask of a call
site is ``rand(shape) < 1 - p`` from a fresh generator on the device seeded
with ``fold_seed`` (splitmix64) of the step's seed, the tower (text 0,
image 1), the block and the site (q, k, v, o, gate, up, down: 0-6), drawn
at the padded batch's shape. Each block is recomputed in the backward pass
(``torch.utils.checkpoint``) so a 3,584-token batch fits in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.decoder import (
    TextDims, _rope, attention, rms_norm, rotary)
from portbench.reference.quant import Linear

TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, data: int) -> int:
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _lora(lin, x, base, ad, seed, p, padded_shape):
    y = lin(x, base["w"], base.get("b"))
    if ad is None:
        return y
    xl = x
    if seed is not None and p > 0.0:
        g = torch.Generator(device=x.device).manual_seed(seed)
        u = torch.rand(padded_shape, generator=g, device=x.device)
        keep = u[:, :x.shape[1]] < 1.0 - p
        xl = torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))
    return y + lin(lin(xl, ad["a"]), ad["b"]) * ad["scale"]


def _block(x, blk, ad, dims, cos, sin, allowed, lin, seed, p, t_pad):
    b, t, _ = x.shape
    dh = dims.head_dim
    site = [0]

    def ld(y, name):
        s = fold_seed(seed, site[0]) if seed is not None else None
        site[0] += 1
        return _lora(lin, y, blk[name], ad.get(name) if ad else None, s, p,
                     (b, t_pad, y.shape[-1]))

    y = rms_norm(x, blk["attn_norm"]["scale"], dims.eps)
    q = ld(y, "q").view(b, t, -1, dh)
    k = ld(y, "k").view(b, t, -1, dh)
    v = ld(y, "v").view(b, t, -1, dh)
    o = attention(_rope(q, cos, sin), _rope(k, cos, sin), v, allowed)
    x = x + ld(o.reshape(b, t, -1), "o")
    y = rms_norm(x, blk["mlp_norm"]["scale"], dims.eps)
    return x + ld(F.silu(ld(y, "gate")) * ld(y, "up"), "down")


def dense_reps(tp: dict, adapters: dict, dims: TextDims,
               embeds: torch.Tensor, mask: torch.Tensor, t_pad: int,
               lin: Linear, lora_seed: Optional[int], p: float
               ) -> torch.Tensor:
    """``[B, H]`` final-normed hidden states at each row's last real
    position, the rows cut to the batch's longest real prompt (masks still
    drawn at the padded length ``t_pad``)."""
    t = int(mask.sum(1).max())
    embeds, mask = embeds[:, :t], mask[:, :t]
    pos = torch.arange(t, device=embeds.device)[None].expand(
        embeds.shape[0], t)
    if dims.mrope is not None:
        pos = pos[None].expand(3, *pos.shape)
    cos, sin = rotary(pos, dims)
    allowed = torch.tril(torch.ones(t, t, dtype=torch.bool,
                                    device=embeds.device))[None] \
        & mask.bool()[:, None, :]
    x = embeds.float()
    for i, blk in enumerate(tp["blocks"]):
        seed = fold_seed(lora_seed, i) if lora_seed is not None else None
        x = checkpoint(_block, x, blk, adapters["text"]["blocks"][i], dims,
                       cos, sin, allowed, lin, seed, p, t_pad,
                       use_reentrant=False)
    x = rms_norm(x, tp["final_norm"]["scale"], dims.eps)
    last = mask.long().sum(1) - 1
    return x[torch.arange(x.shape[0], device=x.device), last]


def info_nce(t: torch.Tensor, i: torch.Tensor, tau: float) -> torch.Tensor:
    t = t / t.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    i = i / i.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    labels = torch.arange(t.shape[0], device=t.device)
    return (F.cross_entropy(i @ t.T / tau, labels)
            + F.cross_entropy(t @ i.T / tau, labels)) / 2


def leaves(adapters: dict) -> List[torch.Tensor]:
    return [blk[n][k] for blk in adapters["text"]["blocks"]
            for n in TARGETS if n in blk for k in ("a", "b", "scale")]


class Adam:
    """The optimizer the recipe states: global-norm clipping, then Adam
    (AdamW with ``weight_decay``) at a constant learning rate."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 max_norm: float, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.max_norm = params, lr, max_norm
        self.wd, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.mu = [torch.zeros_like(x) for x in params]
        self.nu = [torch.zeros_like(x) for x in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Apply one update; returns the gradients as clipped."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        if self.max_norm and norm >= self.max_norm:
            grads = [g / norm.float() * self.max_norm for g in grads]
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for x, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.wd > 0:
                u = u + self.wd * x
            x.sub_(self.lr * u)
        return grads


def train_steps(tp: dict, adapters: dict, dims: TextDims, batches,
                recipe: Dict, seed: int, lin: Linear):
    """Run ``len(batches)`` steps from ``adapters`` (copied, float32).
    ``batches``: per step ``(text_embeds, text_mask, text_pad, image_embeds,
    image_mask, image_pad)``, the image features already in place. Returns
    (losses, each step's clipped gradients, the adapters after the last
    step)."""
    ad = {"text": {"blocks": [
        {n: {k: v.detach().clone().float().requires_grad_(True)
             for k, v in e.items()} for n, e in blk.items()}
        for blk in adapters["text"]["blocks"]]}}
    params = leaves(ad)
    opt = Adam(params, recipe["learning_rate"], recipe["max_grad_norm"],
               recipe["weight_decay"])
    losses, grads_seen = [], []
    p = recipe["lora_dropout"]
    for step, (te, tm, tpad, ie, im, ipad) in enumerate(batches):
        step_seed = fold_seed(seed, step)
        t_rep = dense_reps(tp, ad, dims, te, tm, tpad, lin,
                           fold_seed(step_seed, 0), p)
        i_rep = dense_reps(tp, ad, dims, ie, im, ipad, lin,
                           fold_seed(step_seed, 1), p)
        loss = info_nce(t_rep, i_rep, recipe["tau"])
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(params, grads)]
        grads_seen.append([g.detach() for g in opt.step(grads)])
        losses.append(float(loss.detach()))
    return losses, grads_seen, [x.detach() for x in params]
