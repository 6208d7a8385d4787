"""On-device sparse term selection: top-k on the card, strings stay on host.

- full-vocab top-k for the fallback / manual vectors (``vocab_topk``);
- text vectors: logits gathered at the caption's candidate ids (padded
  ``[B, C]`` with a validity mask), top-k within them (``candidate_topk``);
- expansion terms: top-k over the filtered-id pool (``filtered_topk``);
- ``pad_candidates``: the host side, candidate rows padded to one width.

Ties break toward the lower index, as ``lax.top_k`` and the host golden
implementation (``(-value, index)`` stable sort) do: the selections here are
a stable descending sort, so the same logits give the same terms as the JAX
package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NEG_INF = torch.finfo(torch.float32).min


def _stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def vocab_topk(sparse_logits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the full vocabulary: (values [B, k], token ids [B, k])."""
    k = min(k, sparse_logits.shape[1])
    return _stable_topk(sparse_logits.float(), k)


def candidate_topk(sparse_logits: torch.Tensor, cand_ids: torch.Tensor,
                   cand_mask: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k of logits restricted to per-sample candidate ids.

    Returns (values [B, k], token ids [B, k], counts [B]); rows are valid
    up to ``min(counts[b], k)`` entries, padding scores ``NEG_INF``.
    """
    k = min(k, cand_ids.shape[1])
    ids = cand_ids.long()
    gathered = torch.gather(sparse_logits.float(), 1, ids)
    gathered = gathered.masked_fill(~cand_mask, NEG_INF)
    vals, pos = _stable_topk(gathered, k)
    counts = cand_mask.sum(dim=1).to(torch.int32)
    return vals, torch.gather(ids, 1, pos), counts


def filtered_topk(sparse_logits: torch.Tensor, filtered_mask: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the filtered-id pool only (expansion terms)."""
    k = min(k, sparse_logits.shape[1])
    masked = sparse_logits.float().masked_fill(~filtered_mask[None, :],
                                               NEG_INF)
    return _stable_topk(masked, k)


def pad_candidates(rows, pad_multiple: int = 64):
    """Host helper: sorted candidate id arrays -> (ids [B, C] int32, mask
    [B, C] bool), C the longest row rounded up to ``pad_multiple``."""
    longest = max((len(r) for r in rows), default=1)
    c = max(-(-max(longest, 1) // pad_multiple) * pad_multiple, pad_multiple)
    ids = np.zeros((len(rows), c), np.int32)
    mask = np.zeros((len(rows), c), bool)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = True
    return ids, mask
