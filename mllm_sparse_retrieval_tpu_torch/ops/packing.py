"""Single-fetch results: pack mixed blocks into ONE int32 tensor.

Each device tensor the host reads is one device-to-host copy and one
synchronisation; packing a batch's outputs into one ``[B, W]`` int32 tensor
makes it one. Float blocks travel as their f32 bits in int32 lanes, the same
bit layouts as the JAX package's ``ops/packing.py`` (``pack_topk`` /
``pack_blocks``), so either package's unpackers read the other's output.
Only the i32 wire is ported; the 48-bit ``compact48`` wire waits.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32).contiguous().view(torch.int32)


def pack_topk(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(scores [B, k] f32, idx [B, k] int) -> [B, 2k] int32."""
    return torch.cat([_bits(scores), idx.to(torch.int32)], dim=1)


def unpack_topk(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of ``pack_topk`` (exact bit round trip)."""
    k = packed.shape[1] // 2
    scores = np.ascontiguousarray(packed[:, :k]).view(np.float32)
    return scores, packed[:, k:]


def pack_blocks(blocks: Sequence[Tuple[torch.Tensor, bool]]) -> torch.Tensor:
    """Concat mixed-dtype [B, w] blocks into one [B, sum(w)] int32 tensor.
    ``blocks`` holds (tensor, is_float) pairs; a [B] vector is widened to
    [B, 1]."""
    parts = []
    for a, is_float in blocks:
        if a.dim() == 1:
            a = a[:, None]
        parts.append(_bits(a) if is_float else a.to(torch.int32))
    return torch.cat(parts, dim=1)


def unpack_blocks(packed: np.ndarray, spec):
    """Host-side inverse of ``pack_blocks``: ``spec`` is a sequence of
    (width, is_float) pairs matching the packed layout."""
    out, off = [], 0
    for w, is_float in spec:
        blk = packed[:, off:off + w]
        off += w
        out.append(np.ascontiguousarray(blk).view(np.float32)
                   if is_float else blk)
    if off != packed.shape[1]:
        raise ValueError(f"spec covers {off} of {packed.shape[1]} columns")
    return out
