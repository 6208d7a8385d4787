"""Document filters: search scoped to a set of docs (the JAX package's
``index/filter.py``, one device).

A filter is one ``[n_docs]`` bool operand per search call: the engines
score every doc as usual, set the scores of excluded docs to -inf before
their top-k, and the resolve drops them, so rows become ragged when fewer
than ``depth`` allowed docs match. Any selectivity costs one masked pass.

``DocFilter`` is built once against one index's doc order and caches its
padded device copy per ``(n_padded, device)``, so a reused filter uploads
once.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch


class DocFilter:
    """An immutable allow mask over one index's document positions.

    Build it with :meth:`from_ids` against the index the searches run on
    (positions are index-specific), or directly from a bool mask in that
    index's doc order. Reuse the instance across searches.
    """

    def __init__(self, mask: np.ndarray):
        mask = np.asarray(mask)
        if mask.dtype != np.bool_ or mask.ndim != 1:
            raise ValueError(f"mask must be a 1-D bool array, got "
                             f"{mask.dtype} {mask.shape}")
        self.mask = mask
        self.n_allowed = int(mask.sum())
        self._device: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    @classmethod
    def from_ids(cls, doc_ids, ids: Iterable, mode: str = "allow"
                 ) -> "DocFilter":
        """Build from doc-id strings against ``doc_ids`` (an index's doc
        order: ``ImpactIndex.doc_ids`` or ``DenseFlatIndex.lookup``).
        ``mode='allow'`` keeps exactly these ids, ``'deny'`` excludes them;
        unknown ids match nothing either way."""
        if mode not in ("allow", "deny"):
            raise ValueError(f"mode must be 'allow' or 'deny', got {mode!r}")
        wanted = {str(i) for i in ids}
        hit = np.fromiter((d in wanted for d in doc_ids), np.bool_,
                          len(doc_ids))
        return cls(hit if mode == "allow" else ~hit)

    def device_mask(self, n_padded: int, device="cuda") -> torch.Tensor:
        """The mask padded to ``n_padded`` columns (pad columns False) as a
        bool tensor on ``device``, cached per ``(n_padded, device)``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (int(n_padded), device)
        dev = self._device.get(key)
        if dev is not None:
            return dev
        if n_padded < self.mask.shape[0]:
            raise ValueError(f"filter built for {self.mask.shape[0]} docs; "
                             f"index has {n_padded} padded columns")
        padded = np.zeros(n_padded, np.bool_)
        padded[: self.mask.shape[0]] = self.mask
        dev = torch.from_numpy(padded).to(device)
        self._device[key] = dev
        return dev
