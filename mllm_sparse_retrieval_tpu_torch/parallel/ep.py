"""Mixture-of-Experts FFN on one device (the JAX package's ``parallel/ep.py``).

The decoder FFN becomes a router and ``num_experts`` SwiGLU experts; each
token goes to its ``top_k`` experts (Mixtral / GShard routing). The JAX
package writes the layer as three dense einsums over one-hot ``[N, E, C]``
dispatch and combine tensors, the TPU's form. Here the same function is
computed with index operations: each kept assignment has a seat
``expert * C + position``, the seated tokens are copied into an ``[E, C,
H]`` batch (empty seats zero), the experts run as batched products over it,
and each token sums its experts' rows back with ``index_add``. No ``[N, E,
C]`` tensor is built.

The JAX function's rules, all kept:

- top-k over the router probabilities, the lower expert index first on a
  tie (``lax.top_k``; here a loop of ``argmax``, which returns the first
  maximum); with ``normalize_gates`` the gates are divided by
  ``max(sum, 1e-9)``;
- capacity ``C = ceil(top_k * N / E * capacity_factor)`` rounded up to a
  multiple of 8 (at least 8), capped at ``N``;
- slot-major seating (every first choice before any second choice), token
  order within a slot; assignments past an expert's capacity are dropped,
  so a token's output is the gate-weighted sum of its seated experts only;
- router logits and probabilities in f32 (the router weight is kept f32);
  the seated inputs are exact copies (the JAX dispatch contraction sums one
  term in f32 and casts back); the combine weights are cast to ``x.dtype``
  before the f32-accumulated sum, so bf16 models round the gates to bf16;
- the Switch load-balance loss ``E * sum_e f_e * p_e`` from the
  pre-capacity assignment fractions ``f_e`` and the mean probabilities
  ``p_e``;
- there is no mask: pad tokens are routed and take seats.

Expert parallelism (the JAX package's ``moe_shardings`` /
``shard_moe_params``): the expert stacks split on dim 0 over a mesh axis
(``parallel.mesh.Sharded``, the model axis by default), the router whole.
``moe_ffn`` on such a tree routes on the input's device as before and runs
each device's experts on its slice of the capacity buckets there; the
expert outputs come back to the input's device for the combine, where the
JAX package's dispatch and combine einsums become all-to-alls under GSPMD.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    MODEL_AXIS, Mesh, Sharded, split)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # capacity = ceil(top_k * tokens / experts * capacity_factor), /8-aligned
    capacity_factor: float = 1.25
    # weight of the Switch load-balance aux loss (the trainer multiplies)
    aux_loss_coef: float = 0.01
    # Mixtral renormalises the top-k gates to sum to 1; Switch (k=1) uses
    # the raw softmax probability. True = Mixtral's convention.
    normalize_gates: bool = True


@dataclass
class Routing:
    """Where each (token, slot) assignment went: ``expert`` and ``seat``
    (its position in the expert's capacity bucket), ``keep`` (seated, not
    dropped) and ``gate`` (its f32 weight), all ``[N, top_k]``; ``aux`` is
    the load-balance loss."""

    expert: torch.Tensor
    seat: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor


def moe_init(generator: torch.Generator, hidden: int, intermediate: int,
             cfg: MoEConfig, dtype=torch.float32, device="cuda") -> Dict:
    """Router and stacked expert SwiGLU weights drawn on ``device``:
    ``router`` ``[H, E]`` (f32 whatever ``dtype``: routing logits are
    precision-sensitive), ``gate`` / ``up`` ``[E, H, F]``, ``down`` ``[E, F,
    H]``, each N(0, 1/fan_in) as in the JAX package."""
    e, h, f = cfg.num_experts, hidden, intermediate

    def normal(shape, scale, dt):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dt).mul_(scale)

    s_in, s_mid = 1.0 / math.sqrt(h), 1.0 / math.sqrt(f)
    return {"router": normal((h, e), s_in, torch.float32),
            "gate": normal((e, h, f), s_in, dtype),
            "up": normal((e, h, f), s_in, dtype),
            "down": normal((e, f, h), s_mid, dtype)}


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(cfg.top_k * n_tokens / cfg.num_experts
                  * cfg.capacity_factor)
    return min(max(8 * math.ceil(c / 8), 8), n_tokens)


def _dispatch_combine(probs: torch.Tensor, cfg: MoEConfig,
                      capacity: int) -> Routing:
    """The routing of ``probs`` (``[N, E]`` f32 softmax) into buckets of
    ``capacity`` seats."""
    n, e = probs.shape
    masked = probs.detach().clone()
    experts = []
    for _ in range(cfg.top_k):              # argmax: the first maximum wins
        idx = masked.argmax(dim=-1)
        experts.append(idx)
        masked.scatter_(1, idx[:, None], float("-inf"))
    expert = torch.stack(experts, dim=1)                      # [N, k]
    gate = probs.gather(1, expert)
    if cfg.normalize_gates:
        gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    seated = torch.zeros(e, dtype=torch.int64, device=probs.device)
    seats = []
    for s in range(cfg.top_k):
        onehot = F.one_hot(expert[:, s], e)                   # [N, E]
        # tokens already at this expert: earlier slots, earlier tokens
        pos = torch.cumsum(onehot, dim=0) - onehot + seated
        seats.append(pos.gather(1, expert[:, s:s + 1])[:, 0])
        seated = seated + onehot.sum(dim=0)
    seat = torch.stack(seats, dim=1)
    f_e = seated.float() / (n * cfg.top_k)                    # pre-capacity
    aux = e * torch.sum(f_e * probs.mean(dim=0))
    return Routing(expert, seat, seat < capacity, gate, aux)


def moe_ffn(x: torch.Tensor, p: Dict,
            cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE SwiGLU FFN: ``x [..., H]`` -> ``(y [..., H], aux)``. Routing in
    f32, the expert products in ``x.dtype``, the combine summed in f32."""
    lead, h = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, h)
    n = xf.shape[0]
    capacity = expert_capacity(n, cfg)
    e = cfg.num_experts
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    r = _dispatch_combine(probs, cfg, capacity)
    keep = r.keep.reshape(-1)
    token = torch.arange(n, device=x.device).repeat_interleave(
        cfg.top_k)[keep]
    slot = (r.expert * capacity + r.seat).reshape(-1)[keep]
    xs = xf.new_zeros(e * capacity, h).index_copy(0, slot, xf[token])
    xs = xs.view(e, capacity, h)
    ys = _experts(xs, p).view(e * capacity, h)
    w = r.gate.reshape(-1)[keep].to(x.dtype)
    rows = w.float()[:, None] * ys[slot].float()
    y = xf.new_zeros(n, h, dtype=torch.float32).index_add(0, token, rows)
    return y.to(x.dtype).view(*lead, h), r.aux


def _experts(xs: torch.Tensor, p: Dict) -> torch.Tensor:
    """The stacked SwiGLU experts on their ``[E, C, H]`` buckets; split
    stacks run each piece's experts on its device."""
    if not isinstance(p["gate"], Sharded):
        hid = F.silu(torch.bmm(xs, p["gate"])) * torch.bmm(xs, p["up"])
        return torch.bmm(hid, p["down"])
    gate, up, down = p["gate"], p["up"], p["down"]
    step = xs.shape[0] // len(gate.pieces)
    out = []
    for j, dev in enumerate(gate.devices):
        xj = xs[j * step:(j + 1) * step].to(dev)
        hid = F.silu(torch.bmm(xj, gate.pieces[j])) \
            * torch.bmm(xj, up.pieces[j])
        out.append(torch.bmm(hid, down.pieces[j]).to(xs.device))
    return torch.cat(out)


def moe_shardings(p: Dict, mesh: Mesh, axis: str = MODEL_AXIS) -> Dict:
    """Spec tuples placing the expert dim over ``axis``: the router whole
    (every token needs it), each expert stack split on dim 0."""
    return {k: () if k == "router" else (axis,) + (None,) * (v.dim() - 1)
            for k, v in p.items()}


def shard_moe_params(p: Dict, mesh: Mesh, axis: str = MODEL_AXIS) -> Dict:
    """A new MoE tree with ``moe_shardings``' placement: each device of
    ``axis`` (in the mesh's first data row) holds ``num_experts / n`` of
    every stack, as new tensors; the router is the caller's."""
    n = mesh.shape[axis]
    if p["gate"].shape[0] % n != 0:
        raise ValueError(
            f"num_experts {p['gate'].shape[0]} not divisible by mesh axis "
            f"'{axis}' of size {n}")
    specs = moe_shardings(p, mesh, axis)
    devices = mesh.axis_devices(axis)
    return {k: v if k == "router" else split(v, 0, devices, specs[k])
            for k, v in p.items()}
