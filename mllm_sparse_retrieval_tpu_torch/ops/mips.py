"""Maximum-inner-product search: a matmul and ``torch.topk`` (the JAX
package's ``ops/mips.py``: f32, bf16 and int8 programs, on one device and
over a mesh; that package computes these outside any Pallas kernel too).

Scores are f32 for every corpus dtype:

- an f32 corpus scores in full f32 (``full_f32_matmul``, TF32 off: the
  counterpart of ``precision=HIGHEST``, FAISS-flat parity);
- a bf16 corpus scores bf16-rounded queries against it with f32
  accumulation AND f32 output, as ``preferred_element_type=jnp.float32``
  does (a bf16 ``torch.matmul`` would return bf16 and round every score).
  On the card that is one cuBLAS GEMM, ``torch.mm(..., out_dtype=
  torch.float32)``, which reads the bf16 corpus once. PyTorch has no such
  product on the CPU, so there both operands are widened to f32 (exact: a
  bf16 value is an f32 value) ``_WIDEN_BYTES`` of corpus rows at a time and
  multiplied in full f32. Either way each product of two bf16 values is
  exact in f32, only the accumulation rounds, and no f32 copy of the whole
  corpus is made;
- an int8 (SQ8) corpus scores int8 queries with an exact int8 x int8 ->
  int32 product (``torch._int_mm``), dequantized by the per-query x per-row
  scale outer product (``_q8_scores``), as the JAX package does.

Given a bool ``mask``, each packed program restricts the search to the rows
it allows (``index/filter.py``): excluded rows score -inf before the top-k.

The sharded programs (``sharded_mips_topk``, ``sharded_mips_topk_q8``)
score a corpus split by contiguous row blocks over a mesh's data axis
(``parallel/mesh.py``): each shard's block on its device, the queries
copied to each, rows at or past ``n_valid`` and rows the shard's piece of
``mask`` excludes at -inf, a local top ``min(k, shard_rows)``, then one
top-k over all shards' candidates on the mesh's lead device. They return
``(scores [B, k] f32, global row ids [B, k] int32)`` there, not a packed
tensor: the JAX package's mesh form.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mllm_sparse_retrieval_tpu_torch.ops.packing import pack_topk
from mllm_sparse_retrieval_tpu_torch.ops.score_programs import (
    _filtered, _sharded_merge_topk, full_f32_matmul)
from mllm_sparse_retrieval_tpu_torch.parallel.mesh import replicated

DTYPES = (torch.float32, torch.bfloat16)
# f32 bytes of the corpus rows a bf16 search widens at a time
_WIDEN_BYTES = 32 * 2 ** 20
# torch's CUDA ``_int_mm`` (cuBLASLt) takes more than 16 rows and inner and
# output widths that are multiples of 8: queries pad to Q8_ROW_PAD rows,
# ``DenseFlatIndex`` pads corpus rows and widths to multiples of Q8_ALIGN
Q8_ROW_PAD, Q8_ALIGN = 32, 8


def mips_scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` f32 inner products of ``queries [B, d]`` (cast to the
    corpus dtype first) with ``corpus [N, d]`` (f32 or bf16; an int8
    corpus scores through ``_q8_scores`` with its scales)."""
    if corpus.dtype not in DTYPES:
        raise TypeError(f"corpus dtype {corpus.dtype}: mips_scores takes f32 "
                        f"and bf16 corpora; an int8 corpus needs its row "
                        f"scales (mips_topk_packed_q8)")
    if corpus.dtype == torch.float32:
        with full_f32_matmul():
            return queries.float() @ corpus.T
    if corpus.is_cuda:
        return torch.mm(queries.to(corpus.dtype), corpus.T,
                        out_dtype=torch.float32)
    q = queries.to(corpus.dtype).float()
    out = torch.empty((q.shape[0], corpus.shape[0]), dtype=torch.float32,
                      device=q.device)
    rows = max(1, _WIDEN_BYTES // (4 * max(corpus.shape[1], 1)))
    with full_f32_matmul():
        for r0 in range(0, corpus.shape[0], rows):
            r1 = min(r0 + rows, corpus.shape[0])
            out[:, r0:r1] = q @ corpus[r0:r1].float().T
    return out


def mips_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact MIPS: (scores [B, k'] f32, row indices [B, k']) with
    ``k' = min(k, N)``, scores descending (tie order unspecified)."""
    return torch.topk(mips_scores(queries, corpus),
                      min(k, corpus.shape[0]), dim=1)


def mips_topk_packed(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mips_topk`` as one ``[B, 2k']`` int32 tensor (score bits, then
    indices; ``ops.packing.unpack_topk`` inverts): one copy to the host.
    With ``mask`` (bool ``[N]``) only the rows it allows are searched;
    where fewer than ``k`` are allowed the row ends in -inf entries, which
    ``DenseFlatIndex.search_ids`` drops."""
    scores = mips_scores(queries, corpus)
    if mask is not None:
        _filtered(scores, mask)
    return pack_topk(*torch.topk(scores, min(k, corpus.shape[0]), dim=1))


def _int8_matmul(q8: torch.Tensor, corpus8: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` exact int32 products of int8 ``q8 [B, d]`` and
    ``corpus8 [N, d]``. On CUDA the query rows are zero-padded to
    ``Q8_ROW_PAD`` for cuBLASLt and cut back; ``d`` and ``N`` must already
    be multiples of ``Q8_ALIGN``."""
    b = q8.shape[0]
    if q8.device.type == "cuda":
        if corpus8.shape[0] % Q8_ALIGN or corpus8.shape[1] % Q8_ALIGN:
            raise ValueError(f"int8 corpus {tuple(corpus8.shape)}: rows and "
                             f"width must be multiples of {Q8_ALIGN}")
        pad = max(Q8_ROW_PAD, -(-b // Q8_ALIGN) * Q8_ALIGN) - b
        if pad:
            q8 = torch.cat([q8, q8.new_zeros((pad, q8.shape[1]))])
    return torch._int_mm(q8.contiguous(), corpus8.T)[:b]


def _q8_scores(q8, q_scale, corpus8, row_scale) -> torch.Tensor:
    """SQ8 scores: the exact int32 product dequantized to f32 by the
    per-query x per-row scale outer product, scales multiplied first (the
    JAX package's order, so integer-valued data match it bit for bit)."""
    acc = _int8_matmul(q8, corpus8)
    return acc.float() * (q_scale[:, None] * row_scale[None, :])


def mips_topk_packed_q8(q8: torch.Tensor, q_scale: torch.Tensor,
                        corpus8: torch.Tensor, row_scale: torch.Tensor,
                        k: int, n_valid: Optional[int] = None,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SQ8 MIPS as one ``[B, 2k]`` int32 tensor (``unpack_topk`` inverts).

    ``q8 [B, d]`` / ``corpus8 [N, d]`` int8 with f32 scales ``q_scale
    [B]`` / ``row_scale [N]``. Rows at or past ``n_valid`` (the padding of
    ``DenseFlatIndex``) and rows ``mask`` excludes score -inf; ``k`` is
    taken at most ``n_valid``."""
    scores = _q8_scores(q8, q_scale, corpus8, row_scale)
    n_valid = corpus8.shape[0] if n_valid is None else n_valid
    if mask is not None:
        _filtered(scores, mask)
    if n_valid < scores.shape[1]:
        scores[:, n_valid:] = float("-inf")
    return pack_topk(*torch.topk(scores, min(k, n_valid), dim=1))


# ---- data-axis mesh programs ------------------------------------------------

def _local_then_global_topk(shard_scores, shard_rows: int, n_valid: int,
                            k: int, device: torch.device, masks=None):
    """Each shard's scores cut to its candidates, then the merge
    (``score_programs._sharded_merge_topk``); global row ids as int32."""
    vals, gidx = _sharded_merge_topk(shard_scores, shard_rows, n_valid, k,
                                     device, masks)
    return vals, gidx.to(torch.int32)


def _sharded_statics(corpus_shards: Sequence[torch.Tensor], n_valid: int,
                     k: int) -> int:
    rows = {c.shape[0] for c in corpus_shards}
    if len(rows) != 1:
        raise ValueError(f"corpus shards of unequal rows {sorted(rows)}: "
                         f"pad the corpus to a shard multiple")
    return min(k, n_valid)


def sharded_mips_topk(mesh, queries, corpus_sharded: Sequence[torch.Tensor],
                      n_valid: int, k: int,
                      mask_sharded: Optional[Sequence[torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact MIPS over a row-sharded corpus -> (scores [B, k] f32, global
    row ids [B, k] int32) on ``mesh.lead``, ``k = min(k, n_valid)``.

    ``queries``: one ``[B, d]`` tensor (copied to each shard's device) or
    one copy per shard; ``corpus_sharded``: one ``[shard_rows, d]`` block
    per data shard (f32 or bf16), the corpus padded to a shard multiple,
    padding rows excluded through ``n_valid``; ``mask_sharded``: one bool
    ``[shard_rows]`` piece per shard or None."""
    k = _sharded_statics(corpus_sharded, n_valid, k)
    if isinstance(queries, torch.Tensor):
        queries = replicated(mesh, queries)
    scores = (mips_scores(q, c) for q, c in zip(queries, corpus_sharded))
    return _local_then_global_topk(scores, corpus_sharded[0].shape[0],
                                   n_valid, k, mesh.lead, mask_sharded)


def sharded_mips_topk_q8(mesh, q8, q_scale,
                         corpus8_sharded: Sequence[torch.Tensor],
                         row_scale_sharded: Sequence[torch.Tensor],
                         n_valid: int, k: int,
                         mask_sharded: Optional[Sequence[torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SQ8 MIPS over a row-sharded int8 corpus with its row scales sharded
    alike (the int8 form of ``sharded_mips_topk``, the same contract):
    each shard's exact int8 product (``torch._int_mm`` on the card), its
    dequantization, then the merge."""
    k = _sharded_statics(corpus8_sharded, n_valid, k)
    if isinstance(q8, torch.Tensor):
        q8, q_scale = replicated(mesh, q8), replicated(mesh, q_scale)
    scores = (_q8_scores(q, s, c, r) for q, s, c, r in
              zip(q8, q_scale, corpus8_sharded, row_scale_sharded))
    return _local_then_global_topk(scores, corpus8_sharded[0].shape[0],
                                   n_valid, k, mesh.lead, mask_sharded)
