"""Maximum-inner-product search on one device: a matmul and ``torch.topk``
(the JAX package's ``ops/mips.py``, single-device f32 and bf16 programs;
that package computes these outside any Pallas kernel too).

Scores are f32 for either corpus dtype:

- an f32 corpus scores in full f32 (``full_f32_matmul``, TF32 off: the
  counterpart of ``precision=HIGHEST``, FAISS-flat parity);
- a bf16 corpus scores bf16-rounded queries against it with f32
  accumulation AND f32 output, as ``preferred_element_type=jnp.float32``
  does. A CUDA bf16 ``torch.matmul`` would return bf16 and round every
  score, so both operands are widened to f32 (exact: a bf16 value is an f32
  value) and multiplied in full f32; each product of two bf16 values is
  exact in f32, so only the accumulation rounds.

Given a bool ``mask``, ``mips_topk_packed`` restricts the search to the rows
it allows (``index/filter.py``): excluded rows score -inf before the top-k.
Not ported: the int8 (SQ8) programs, filtered or not, and the sharded ones
(ROADMAP Queue 1 #5, #9).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mllm_sparse_retrieval_tpu_torch.ops.packing import pack_topk
from mllm_sparse_retrieval_tpu_torch.ops.score_programs import (
    _filtered, full_f32_matmul)

DTYPES = (torch.float32, torch.bfloat16)


def mips_scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` f32 inner products of ``queries [B, d]`` (cast to the
    corpus dtype first) with ``corpus [N, d]`` (f32 or bf16)."""
    if corpus.dtype not in DTYPES:
        raise TypeError(f"corpus dtype {corpus.dtype}: the port scores f32 "
                        f"and bf16 corpora (int8 is ROADMAP Queue 1 #5)")
    q = queries.to(corpus.dtype).float()
    with full_f32_matmul():
        return q @ corpus.float().T


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
