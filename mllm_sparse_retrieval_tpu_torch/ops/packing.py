"""Single-fetch results: pack mixed blocks into ONE int32 tensor.

Each device tensor the host reads is one device-to-host copy and one
synchronisation; packing a batch's outputs into one ``[B, W]`` int32 tensor
makes it one. Float blocks travel as their f32 bits in int32 lanes, the same
bit layouts as the JAX package's ``ops/packing.py`` (``pack_topk`` /
``pack_blocks``), so either package's unpackers read the other's output.

``pack_topk48`` is the ``compact48`` wire of integer-scored (impact)
searches: 6 bytes a result instead of 8. torch has no arithmetic on
``uint16``, so the lanes are computed in int32 and stored as int16 bits;
``unpack_topk48`` reads them as uint16, and the bytes on the host equal the
JAX package's ``uint16`` array bit for bit.
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


_SCORE24_MAX = 2 ** 24 - 1


def pack_topk48(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(scores [B, k], idx [B, k]) -> [B, 3k] int16 holding three uint16
    lanes: ``(score_hi8 << 8) | idx_hi7``, ``score_lo16``, ``idx_lo16``.

    For integer scores only: scores are clamped to ``[0, 2^24 - 1]`` (a
    -inf fill entry becomes 0, which the resolve drops as it drops a zero
    score) and doc positions must be below ``2^23``."""
    s = scores.float().clamp(0.0, float(_SCORE24_MAX)).to(torch.int32)
    i = idx.to(torch.int32)
    lanes = torch.cat([((s >> 16) << 8) | (i >> 16), s & 0xFFFF,
                       i & 0xFFFF], dim=1)
    # uint16 bits in int16: values >= 2^15 wrap by 2^16, exactly
    return torch.where(lanes >= 1 << 15, lanes - (1 << 16),
                       lanes).to(torch.int16)


def unpack_topk48(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of ``pack_topk48`` (int16 or uint16 lanes) ->
    (scores f32, idx int32)."""
    a = np.asarray(packed)
    if a.dtype == np.int16:
        a = a.view(np.uint16)
    a = a.astype(np.int32)
    k = a.shape[1] // 3
    l0, l1, l2 = a[:, :k], a[:, k:2 * k], a[:, 2 * k:]
    scores = (((l0 >> 8) << 16) | l1).astype(np.float32)
    return scores, ((l0 & 0xFF) << 16) | l2


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
