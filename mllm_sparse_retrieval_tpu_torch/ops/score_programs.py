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
