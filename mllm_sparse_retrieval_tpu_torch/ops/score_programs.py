"""Device scoring programs of the impact index, single device.

- ``_scatter_block``: CSR triples into the dense ``[T+1, N_pad]`` matrix;
- ``_query_table`` + ``_scores_from_matrix``: the matmul backend, one f32
  matmul of a ``[B, T+1]`` query-weight table by the matrix;
- ``_taat_scores``: the term-at-a-time backend (``ops/impact_kernel.py``);
- ``_masked_topk``, ``_impact_topk``, ``_taat_topk``: top-k over the valid
  doc columns, packed into one int32 result (``ops/packing.py``). Given a
  ``[N_pad]`` bool ``mask`` (``index/filter.py``), the top-k is restricted
  to the doc columns it allows: the scorer runs unchanged, excluded columns
  score -inf before the top-k (``_filtered``), and the resolve drops them.
- ``_impact_topk48``, ``_taat_topk48``: the same top-k on the ``compact48``
  wire (``packing.pack_topk48``, 6 bytes a result). Filtered, the -inf of
  an excluded column clamps to score 0 in the pack, and the resolve drops
  it with the zero scores: impact scores are non-negative integers, so a
  masked doc can never outrank a matching one.

The sharded programs (``_sharded_impact_topk``, ``_sharded_taat_topk``)
score a matrix split by contiguous doc-column blocks over a mesh's data
axis (``parallel/mesh.py``): one ``[T+1, shard_cols]`` tensor per shard on
its shard's device, shard ``d``'s column ``c`` the global doc ``d *
shard_cols + c``. Each shard runs the single-device scorer (the TAAT kernel
once per shard on the card), masks its columns at or past ``n_valid`` and
those the shard's piece of ``mask`` excludes, and keeps its own top
``min(k, shard_cols)``; the candidates go to the mesh's lead device, where
one top-k over them picks the global top-k (``_sharded_merge_topk``, the
JAX package's all-gather merge). ``_sharded_scatter`` writes triples routed
to their shards, local columns, into each shard in place.

Query arrays may arrive as int16 (``ImpactIndex._compact_queries``, half
the upload bytes); ``_safe_query`` widens them on the device.

Both backends give exactly equal scores for integer weights: every product
and partial sum is an integer below 2^24, exact in f32 in any order. That
needs the matmul in full f32, the counterpart of the JAX package's
``precision=HIGHEST``: ``_scores_from_matrix`` multiplies inside
``full_f32_matmul``, which turns PyTorch's TF32 matmul switch off for that
one matmul and restores the caller's setting after it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

import torch

from mllm_sparse_retrieval_tpu_torch.ops.impact_kernel import (
    impact_scores_taat)
from mllm_sparse_retrieval_tpu_torch.ops.packing import (
    pack_topk, pack_topk48)


_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def full_f32_matmul():
    """Run the enclosed CUDA f32 matmuls without TF32, then restore the
    process's setting. The lock keeps concurrent searches from restoring
    each other's switch."""
    with _TF32_LOCK:
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved


def _scatter_block(mat: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """Write (row, col, value) triples into ``mat`` in place and return it.
    Padding triples target (row 0, col 0) with value 0, which row 0's zero
    invariant absorbs."""
    mat.index_put_((rows.long(), cols.long()), vals.to(mat.dtype))
    return mat


def _safe_query(q_idx: torch.Tensor, q_w: torch.Tensor):
    """Term t -> matrix row t+1; non-positive weights -> dead row 0."""
    live = q_w > 0
    safe_idx = torch.where(live, q_idx.long() + 1, 0)
    safe_w = torch.where(live, q_w.float(), 0.0)
    return safe_idx, safe_w


def _query_table(q_idx: torch.Tensor, q_w: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """Accumulate query weights into a dense ``[B, num_rows]`` f32 table;
    duplicate term ids add."""
    safe_idx, safe_w = _safe_query(q_idx, q_w)
    table = torch.zeros((q_idx.shape[0], num_rows), dtype=torch.float32,
                        device=q_idx.device)
    return table.scatter_add_(1, safe_idx, safe_w)


def _scores_from_matrix(matrix: torch.Tensor, q_idx: torch.Tensor,
                        q_w: torch.Tensor) -> torch.Tensor:
    """``[B, N_pad]`` impact scores = query table @ impact matrix, in full
    f32 (TF32 off, so integer weights stay exact)."""
    table = _query_table(q_idx, q_w, matrix.shape[0])
    with full_f32_matmul():
        return table @ matrix.float()


def _taat_scores(matrix: torch.Tensor, q_idx: torch.Tensor,
                 q_w: torch.Tensor) -> torch.Tensor:
    """Term-at-a-time scores from raw term ids (shifted and padded here)."""
    safe_idx, safe_w = _safe_query(q_idx, q_w)
    return impact_scores_taat(matrix, safe_idx.to(torch.int32).contiguous(),
                              safe_w.contiguous())


def _filtered(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Excluded doc columns (or MIPS rows) -> -inf. In place on the
    scorer's own fresh ``[B, N]`` tensor, so a filter adds no score-sized
    tensor to a chunk's peak."""
    return scores.masked_fill_(~mask[None, :], float("-inf"))


def _masked_topk(scores: torch.Tensor, n_valid: int, k: int, mask=None):
    """Top-k over the first ``n_valid`` doc columns (padding columns score
    -inf), and over those ``mask`` allows when one is given. Ties may come
    out in any order; callers compare (score, id) sets."""
    if mask is not None:
        _filtered(scores, mask)
    col = torch.arange(scores.shape[1], device=scores.device)
    scores = scores.masked_fill(col[None, :] >= n_valid, float("-inf"))
    return torch.topk(scores, k, dim=1)


def _impact_topk(matrix, q_idx, q_w, n_valid: int, k: int,
                 mask=None) -> torch.Tensor:
    """Matmul backend -> packed ``[B, 2k]`` int32 (scores bits, doc ids)."""
    return pack_topk(*_masked_topk(
        _scores_from_matrix(matrix, q_idx, q_w), n_valid, k, mask))


def _taat_topk(matrix, q_idx, q_w, n_valid: int, k: int,
               mask=None) -> torch.Tensor:
    """TAAT backend -> packed ``[B, 2k]`` int32 (scores bits, doc ids)."""
    return pack_topk(*_masked_topk(
        _taat_scores(matrix, q_idx, q_w), n_valid, k, mask))


def _impact_topk48(matrix, q_idx, q_w, n_valid: int, k: int,
                   mask=None) -> torch.Tensor:
    """Matmul backend -> ``[B, 3k]`` compact48 lanes (integer scores)."""
    return pack_topk48(*_masked_topk(
        _scores_from_matrix(matrix, q_idx, q_w), n_valid, k, mask))


def _taat_topk48(matrix, q_idx, q_w, n_valid: int, k: int,
                 mask=None) -> torch.Tensor:
    """TAAT backend -> ``[B, 3k]`` compact48 lanes (integer scores)."""
    return pack_topk48(*_masked_topk(
        _taat_scores(matrix, q_idx, q_w), n_valid, k, mask))


# ---- data-axis mesh programs ------------------------------------------------

def _shard_topk(scores: torch.Tensor, base: int, n_valid: int, k: int):
    """One shard's candidates: its columns at or past global ``n_valid``
    score -inf (in place), then its top ``min(k, shard_cols)`` with global
    ids ``base + local``."""
    col = base + torch.arange(scores.shape[1], device=scores.device)
    scores.masked_fill_(col[None, :] >= n_valid, float("-inf"))
    lv, li = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    return lv, li + base


def _merge_topk(parts, k: int, device: torch.device):
    """The all-gather and global re-rank: every shard's ``[B, k_local]``
    candidates copied to ``device`` (asynchronous where they live
    elsewhere), concatenated, and one top-k -> (scores [B, k], global ids
    [B, k] int64)."""
    av = torch.cat([v.to(device, non_blocking=True) for v, _ in parts], 1)
    ag = torch.cat([g.to(device, non_blocking=True) for _, g in parts], 1)
    vals, pos = torch.topk(av, k, dim=1)
    return vals, torch.gather(ag, 1, pos)


def _sharded_merge_topk(shard_scores, shard_cols: int, n_valid: int, k: int,
                        device: torch.device,
                        masks: Optional[Sequence[torch.Tensor]] = None):
    """Per-shard top-k of each ``[B, shard_cols]`` score block (shard
    ``d``'s global ids ``d * shard_cols + local``; columns at or past
    ``n_valid``, and those shard ``d``'s piece of ``masks`` excludes,
    score -inf in place) merged into the global top ``k`` on ``device``.
    ``shard_scores`` may be a generator: each shard is then cut to its
    candidates before the next is scored."""
    parts = []
    for d, scores in enumerate(shard_scores):
        if masks is not None:
            _filtered(scores, masks[d])
        parts.append(_shard_topk(scores, d * shard_cols, n_valid, k))
    return _merge_topk(parts, k, device)


def _sharded_topk(scorer, mesh, shards: Sequence[torch.Tensor],
                  q_idx: Sequence[torch.Tensor], q_w: Sequence[torch.Tensor],
                  n_valid: int, k: int,
                  mask: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
    scores = (scorer(m, q_idx[d], q_w[d]) for d, m in enumerate(shards))
    return pack_topk(*_sharded_merge_topk(scores, shards[0].shape[1],
                                          n_valid, k, mesh.lead, mask))


def _sharded_impact_topk(mesh, shards: Sequence[torch.Tensor], q_idx, q_w,
                         n_valid: int, k: int,
                         mask: Optional[Sequence[torch.Tensor]] = None
                         ) -> torch.Tensor:
    """Doc-column-sharded matmul scoring + merge -> packed ``[B, 2k]``
    int32 on ``mesh.lead``. ``shards``: one ``[T+1, shard_cols]`` f32
    block per data shard; ``q_idx`` / ``q_w``: one copy per shard
    (``parallel.mesh.replicated``); ``mask``: one ``[shard_cols]`` bool
    piece per shard or None."""
    return _sharded_topk(_scores_from_matrix, mesh, shards, q_idx, q_w,
                         n_valid, k, mask)


def _sharded_taat_topk(mesh, shards: Sequence[torch.Tensor], q_idx, q_w,
                       n_valid: int, k: int,
                       mask: Optional[Sequence[torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Doc-column-sharded term-at-a-time scoring + merge: the TAAT kernel
    runs once per shard on its block (int16 or f32), then as
    ``_sharded_impact_topk``."""
    return _sharded_topk(_taat_scores, mesh, shards, q_idx, q_w, n_valid, k,
                         mask)


def _sharded_scatter(shards: Sequence[torch.Tensor],
                     rows: Sequence[torch.Tensor],
                     cols: Sequence[torch.Tensor],
                     vals: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Write each shard's own (row, LOCAL column, value) triples into it in
    place; the host routed every triple to the shard owning its column."""
    return [_scatter_block(m, r, c, v)
            for m, r, c, v in zip(shards, rows, cols, vals)]
