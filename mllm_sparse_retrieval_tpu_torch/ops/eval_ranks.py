"""Target hit ranks from a packed top-k on the device (the JAX package's
``ops/eval_ranks.py``; plain torch ops).

When the product of a search is its metrics, the run need not leave the
device: these ops compute each query's target ranks from the packed top-k,
and the host copies one ``[B, 1+T]`` int32 tensor per chunk.
``eval/device_eval.py`` turns the ranks into recall, MRR, nDCG and MAP,
which are exact functions of them under binary relevance.

Ranks follow the host consumers on the same device output: entries rank in
packed order (the resolve paths hand rows score-descending and the host
metrics sort stably), and invalid entries take no rank, as the host paths
drop them: non-positive scores of impact runs (``positive``), non-finite
scores of fused and filtered runs (``finite``), none of an unfiltered dense
run (``all``), and the self doc under ``remove_query``.
``ranks_from_parts`` (the mesh dense form) waits for sharding (ROADMAP
Queue 1 #9).
"""

from __future__ import annotations

import torch

# the rank of a target that is not among the valid entries: larger than any
# depth, so every `rank <= k` test fails
NO_HIT = 2 ** 30

RULES = ("positive", "finite", "all")


def _ranks_core(scores: torch.Tensor, idx: torch.Tensor, tgt: torch.Tensor,
                self_pos: torch.Tensor, rule: str) -> torch.Tensor:
    """(scores [B, K] f32, idx [B, K], tgt [B, T] (-1 pad), self_pos [B]
    (-1 none)) -> [B, 1+T] int32: column 0 is the row's count of valid
    entries, column 1+j target j's 1-based rank among them (``NO_HIT`` when
    absent)."""
    if rule == "positive":
        valid = scores > 0.0
    elif rule == "finite":
        valid = torch.isfinite(scores)
    elif rule == "all":
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    else:
        raise ValueError(f"unknown validity rule {rule!r}")
    b = scores.shape[0]
    if scores.shape[1] == 0:
        return torch.cat([
            torch.zeros((b, 1), dtype=torch.int32, device=scores.device),
            torch.full((b, tgt.shape[1]), NO_HIT, dtype=torch.int32,
                       device=scores.device)], dim=1)
    valid = valid & (idx != self_pos[:, None])
    cum = torch.cumsum(valid.to(torch.int32), dim=1, dtype=torch.int32)
    hit = valid[:, :, None] & (idx[:, :, None] == tgt[:, None, :])
    ranks = torch.where(hit, cum[:, :, None], NO_HIT).amin(dim=1)
    return torch.cat([cum[:, -1:], ranks], dim=1).to(torch.int32)


def ranks_from_packed(packed: torch.Tensor, tgt: torch.Tensor,
                      self_pos: torch.Tensor,
                      rule: str = "positive") -> torch.Tensor:
    """Target ranks from a packed ``[B, 2K]`` int32 top-k (score bits in
    the left half, doc positions in the right); ``tgt`` int32 ``[B, T]``,
    ``self_pos`` int32 ``[B]``, on the packed tensor's device."""
    k = packed.shape[1] // 2
    scores = packed[:, :k].contiguous().view(torch.float32)
    return _ranks_core(scores, packed[:, k:], tgt, self_pos, rule)
