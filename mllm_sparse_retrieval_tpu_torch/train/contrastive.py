"""Symmetric InfoNCE with global negatives (the JAX package's
``train/contrastive.py``).

L2-normalised text and image reps, the similarity of every item against the
batch of the other modality divided by tau, cross-entropy against the
diagonal, averaged over both directions. ``info_nce_loss`` takes the whole
batch on one device; ``sharded_info_nce_loss`` takes it as data shards of a
``parallel.mesh.Mesh``, each shard's loss computed on its device against
the gathered batch.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mllm_sparse_retrieval_tpu_torch.models.reps import normalize
from mllm_sparse_retrieval_tpu_torch.parallel import multihost


def _symmetric_ce(i2t_sim: torch.Tensor, t2i_sim: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    def ce(sim):
        logp = torch.log_softmax(sim.float(), dim=-1)
        return -logp.gather(1, labels[:, None]).mean()
    return (ce(i2t_sim) + ce(t2i_sim)) / 2.0


def info_nce_loss(text_reps: torch.Tensor, img_reps: torch.Tensor,
                  tau: float) -> torch.Tensor:
    """Batch symmetric InfoNCE (f32 scalar)."""
    t = normalize(text_reps)
    i = normalize(img_reps)
    i2t = (i @ t.T) / tau
    t2i = (t @ i.T) / tau
    labels = torch.arange(t.shape[0], device=t.device)
    return _symmetric_ce(i2t, t2i, labels)


def sharded_info_nce_loss(mesh, text_reps: Sequence[torch.Tensor],
                          img_reps: Sequence[torch.Tensor], tau: float,
                          gather_save_gradient: bool = True) -> torch.Tensor:
    """The global-batch loss from per-shard reps: ``text_reps[i]`` /
    ``img_reps[i]`` are data shard ``i``'s rows, on
    ``mesh.shard_devices[i]``. Each shard gathers every shard's normalised
    reps onto its device, scores its own rows against them (labels offset
    by its position) and takes the mean of its rows; the loss is the mean
    over the shards, on ``mesh.lead``. ``gather_save_gradient=True`` is
    ``info_nce_loss`` of the concatenated batch; ``False`` detaches the
    gathered copies of the other shards' reps and keeps the shard's own
    rows differentiable (the reference's detach-and-reinsert): the same
    loss, gradients only through each shard's own rows.

    Over a data axis that spans processes (``mesh.processes`` > 1) the
    shards are this process's, the other processes' rows come through
    ``multihost.all_gather_rows`` (differentiable with the gather, detached
    without it) and the labels are offset by the global row. The value is
    the global loss in every process; the gradient is this process's share
    of it (its rows' terms over the global shard count), so the sum of the
    processes' gradients (the trainer's all-reduce) is the global loss's."""
    n = len(mesh.shard_devices)
    if len(text_reps) != n or len(img_reps) != n:
        raise ValueError(f"{len(text_reps)} / {len(img_reps)} shards for a "
                         f"data axis of {n}")
    t_norm = [normalize(t) for t in text_reps]
    i_norm = [normalize(i) for i in img_reps]
    lead = mesh.lead
    if mesh.processes > 1:
        # every shard's rows in global order, the local ones on the lead
        t_here = torch.cat([t.to(lead) for t in t_norm])
        i_here = torch.cat([x.to(lead) for x in i_norm])
        if not gather_save_gradient:
            t_here, i_here = t_here.detach(), i_here.detach()
        t_glob = multihost.all_gather_rows(t_here)
        i_glob = multihost.all_gather_rows(i_here)
        t_parts = list(t_glob.chunk(mesh.data_size))
        i_parts = list(i_glob.chunk(mesh.data_size))
        if gather_save_gradient:
            # the gathered rows carry the gradient, own rows included
            t_norm = t_parts[mesh.data_offset:mesh.data_offset + n]
            i_norm = i_parts[mesh.data_offset:mesh.data_offset + n]
    else:
        t_parts, i_parts = t_norm, i_norm
    total = len(t_parts)
    losses = []
    offset = sum(p.shape[0] for p in t_parts[:mesh.data_offset])
    for s, dev in enumerate(mesh.shard_devices):
        t_loc, i_loc = t_norm[s], i_norm[s]
        b = t_loc.shape[0]
        own = mesh.data_offset + s

        def gathered(parts, mine):
            return torch.cat([mine if r == own else (
                parts[r] if gather_save_gradient else parts[r].detach()
            ).to(dev) for r in range(total)])

        t_all, i_all = gathered(t_parts, t_loc), gathered(i_parts, i_loc)
        labels = torch.arange(b, device=dev) + offset
        loss = _symmetric_ce((i_loc @ t_all.T) / tau,
                             (t_loc @ i_all.T) / tau, labels)
        losses.append(loss.to(lead))
        offset += b
    if mesh.processes == 1:
        return torch.stack(losses).mean()
    return multihost.global_sum(torch.stack(losses).sum() / total)
