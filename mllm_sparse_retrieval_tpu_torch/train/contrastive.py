"""Symmetric InfoNCE over in-batch negatives (the JAX package's
``train/contrastive.py``, one device).

L2-normalised text and image reps, the similarity of every item against the
batch of the other modality divided by tau, cross-entropy against the
diagonal, averaged over both directions. The cross-device form
(``sharded_info_nce_loss``) waits for training over a mesh (ROADMAP
Queue 1 #9b).
"""

from __future__ import annotations

import torch

from mllm_sparse_retrieval_tpu_torch.models.reps import normalize


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
