"""Hybrid run fusion on the device: two engines' packed top-k in, one packed
fused top-k out (the JAX package's ``ops/hybrid_fusion.py``; plain torch
ops there as here, no kernel).

Per query: min-max normalisation of each run, run membership by a sort and
``searchsorted`` per row (O(k log k), no ``[B, N]`` tensor), the weighted
sum of the host ``search.fusion.fuse`` rule, and one final top-k, so the
host copies one ``[B, 2 * out_k]`` int32 tensor per chunk.

The semantics of ``fuse`` that this reproduces exactly:

- a doc missing from one run contributes 0 from that run;
- each run's min and max are taken over all its returned scores, before
  self-hit removal (the ``make_run`` convention);
- the sparse run drops non-positive scores (``ImpactIndex._resolve_encoded``
  drops them before the run is built) and impact columns whose ``perm``
  entry is -1;
- the denominator is ``max(hi - lo, 1e-9)``;
- a row whose union holds fewer than ``out_k`` docs is filled with -inf,
  which the resolve drops.

Arithmetic is f32 here against float64 on the host, so fused scores agree
to f32 rounding, and docs of equal score may come out in another order.
``fused_topk_parts`` (the mesh dense form) waits for sharding (ROADMAP
Queue 1 #9).
"""

from __future__ import annotations

import torch

from mllm_sparse_retrieval_tpu_torch.ops.packing import pack_topk

_INT_MAX = 2 ** 31 - 1


def _norm_stats(scores: torch.Tensor, valid: torch.Tensor):
    """Per-row min over ``valid`` entries and the fuse denominator. Rows
    with no valid entry get (0, 1e-9): their entries are masked out of the
    candidates anyway; this keeps the arithmetic free of NaN."""
    if scores.shape[1] == 0:
        zero = scores.new_zeros(scores.shape[0])
        return zero, zero + 1e-9
    any_valid = valid.any(dim=1)
    lo = torch.where(any_valid, torch.where(valid, scores, float("inf"))
                     .amin(dim=1), 0.0)
    hi = torch.where(any_valid, torch.where(valid, scores, float("-inf"))
                     .amax(dim=1), 0.0)
    return lo, torch.clamp(hi - lo, min=1e-9)


def _membership(ids_sorted: torch.Tensor, probe: torch.Tensor):
    """Row-wise membership of ``probe`` in ``ids_sorted`` (ascending rows):
    (found [B, k] bool, clipped gather positions [B, k])."""
    width = ids_sorted.shape[1]
    if width == 0:
        return (torch.zeros(probe.shape, dtype=torch.bool,
                            device=probe.device),
                torch.zeros(probe.shape, dtype=torch.long,
                            device=probe.device))
    pos = torch.searchsorted(ids_sorted, probe)          # side="left"
    pos_c = pos.clamp(0, width - 1)
    found = (pos < width) & (torch.gather(ids_sorted, 1, pos_c) == probe)
    return found, pos_c


def _fused_core(ss, si, ds, di, perm, self_idx, w_dense, w_sparse,
                out_k: int):
    """Sparse top-k (scores [B, ks] f32, impact-local ids [B, ks] int32),
    dense top-k (scores [B, kd] f32, dense-local ids [B, kd] int32), the
    impact->dense ``perm`` (-1 = absent), the dense-local self index per
    row (-1 = keep all) and the two weights (0-d f32) -> fused (scores,
    dense-local ids), ``min(out_k, ks + kd)`` wide."""
    ks, kd = si.shape[1], di.shape[1]

    # sparse run membership, in the dense index's doc order
    in_run_s = ss > 0.0
    gsi = torch.where(in_run_s,
                      perm[si.long().clamp(0, perm.shape[0] - 1)], -1)
    in_run_s = in_run_s & (gsi >= 0)
    in_run_d = torch.ones_like(ds, dtype=torch.bool)

    # min / max before self-hit removal (the make_run convention)
    lo_s, den_s = _norm_stats(ss, in_run_s)
    lo_d, den_d = _norm_stats(ds, in_run_d)
    norm_s = torch.where(in_run_s, (ss - lo_s[:, None]) / den_s[:, None],
                         0.0)
    norm_d = (ds - lo_d[:, None]) / den_d[:, None]

    # self-hit removal after the stats
    valid_s = in_run_s & (gsi != self_idx[:, None])
    valid_d = in_run_d & (di != self_idx[:, None])

    # each run's valid ids sorted once; invalid entries sort to the top end
    # and never match a probe (a probe is -1 or a real id below _INT_MAX)
    di_eff = torch.where(valid_d, di, _INT_MAX)
    d_order = torch.argsort(di_eff, dim=1, stable=True)
    di_sorted = torch.gather(di_eff, 1, d_order)
    norm_d_sorted = torch.gather(norm_d, 1, d_order)

    gsi_eff = torch.where(valid_s, gsi, _INT_MAX)
    gsi_sorted = torch.gather(
        gsi_eff, 1, torch.argsort(gsi_eff, dim=1, stable=True))

    # candidates of the sparse run, with the dense part where the doc is in
    # the dense run too
    probe_s = torch.where(valid_s, gsi, -1)
    found_d, pos_d = _membership(di_sorted, probe_s)
    d_at_s = torch.where(found_d, torch.gather(norm_d_sorted, 1, pos_d),
                         0.0)
    cand_s = torch.where(valid_s, w_sparse * norm_s + w_dense * d_at_s,
                         float("-inf"))

    # candidates of the dense run: docs also in the sparse run were emitted
    # above with both parts
    found_s, _ = _membership(gsi_sorted, torch.where(valid_d, di, -1))
    cand_d = torch.where(valid_d & ~found_s, w_dense * norm_d,
                         float("-inf"))

    cand_scores = torch.cat([cand_s, cand_d], dim=1)
    cand_ids = torch.cat([probe_s, di], dim=1)
    out_s, pos = torch.topk(cand_scores, min(out_k, ks + kd), dim=1)
    return out_s, torch.gather(cand_ids, 1, pos)


def _unpack_dev(packed: torch.Tensor):
    k = packed.shape[1] // 2
    return packed[:, :k].contiguous().view(torch.float32), \
        packed[:, k:].contiguous()


def fused_topk_packed(sparse_packed: torch.Tensor,
                      dense_packed: torch.Tensor, perm: torch.Tensor,
                      self_idx: torch.Tensor, w_dense: torch.Tensor,
                      w_sparse: torch.Tensor, out_k: int) -> torch.Tensor:
    """Fuse two engines' packed device results (``[B, 2ks]`` of the impact
    index, ``[B, 2kd]`` of the dense index, int32) into one packed
    ``[B, 2 * out_k']`` int32 tensor (``ops.packing.unpack_topk`` inverts).
    ``perm`` is int32 ``[n_impact]``, ``self_idx`` int32 ``[B]``, the
    weights 0-d f32 tensors, all on the inputs' device; nothing waits on
    the host."""
    ss, si = _unpack_dev(sparse_packed)
    ds, di = _unpack_dev(dense_packed)
    return pack_topk(*_fused_core(ss, si, ds, di, perm, self_idx,
                                  w_dense, w_sparse, out_k))
