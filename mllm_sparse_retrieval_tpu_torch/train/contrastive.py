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
from mllm_sparse_retrieval_tpu_torch.parallel.mesh import DATA_AXIS


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
    loss, gradients only through each shard's own rows."""
    n = mesh.shape[DATA_AXIS]
    if len(text_reps) != n or len(img_reps) != n:
        raise ValueError(f"{len(text_reps)} / {len(img_reps)} shards for a "
                         f"data axis of {n}")
    t_norm = [normalize(t) for t in text_reps]
    i_norm = [normalize(i) for i in img_reps]
    losses = []
    offset = 0
    for s, dev in enumerate(mesh.shard_devices):
        t_loc, i_loc = t_norm[s], i_norm[s]
        b = t_loc.shape[0]

        def gathered(parts, own):
            return torch.cat([own if r == s else (
                parts[r] if gather_save_gradient else parts[r].detach()
            ).to(dev) for r in range(n)])

        t_all, i_all = gathered(t_norm, t_loc), gathered(i_norm, i_loc)
        labels = torch.arange(b, device=dev) + offset
        loss = _symmetric_ce((i_loc @ t_all.T) / tau,
                             (t_loc @ i_all.T) / tau, labels)
        losses.append(loss.to(mesh.lead))
        offset += b
    return torch.stack(losses).mean()
