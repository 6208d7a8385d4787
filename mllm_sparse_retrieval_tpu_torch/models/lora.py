"""LoRA adapter trees: init over targeted projections, merge, save/load.

The JAX package's ``models/lora.py``: the adapter is a parallel tree aligned
with the model params (``{"text": {"blocks": [...]}, "vision": ...,
"projector": ...}``), each entry ``{"a": [in, r], "b": [r, out], "scale":
()}`` beside the dense weight it adapts: the language-model projections by
default (every linear except the LM head), optionally the vision tower
and/or the projector. Merging folds each low-rank delta into its dense
weight, PEFT's ``merge_and_unload``.

Adapter files use the JAX package's format, a pickle of nested dicts and
lists of numpy arrays, so a file written by either package loads in the
other. numpy has no bfloat16: bf16 leaves are written as float32.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

import torch

from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_lora
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig

# Per-submodule linear names eligible for adapters (LM head excluded).
TEXT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
VISION_TARGETS = ("qkv", "out", "fc1", "fc2")
PROJECTOR_TARGETS = ("fc1", "fc2")


def init_lora(generator: torch.Generator, params: Dict, cfg: MLLMConfig,
              rank: int = 8, alpha: float = 16.0, train_vision: bool = False,
              train_projector: bool = False, dtype=torch.float32,
              device="cuda") -> Dict:
    """Build a LoRA tree aligned with ``params``: text blocks always, the
    ViT blocks and the projector on request. Draws come from ``generator``
    (on ``device``) in tree order; they differ from the JAX package's, whose
    tree structure, shapes and dtypes they share."""

    def make(w):
        return L.lora_init(generator, w.shape[0], w.shape[1], rank, alpha,
                           dtype, device)

    lora: Dict = {"text": {"blocks": [
        {name: make(blk[name]["w"]) for name in TEXT_TARGETS if name in blk}
        for blk in params["text"]["blocks"]]}}
    if train_vision:
        lora["vision"] = {"blocks": [
            {name: make(blk[name]["w"]) for name in VISION_TARGETS}
            for blk in params["vision"]["blocks"]]}
    if train_projector:
        lora["projector"] = {name: make(params["projector"][name]["w"])
                             for name in PROJECTOR_TARGETS}
    return lora


def merge_lora(params: Dict, lora: Dict) -> Dict:
    """Fold adapters into dense weights; returns new params (inputs
    unchanged, untouched subtrees shared)."""
    merged = dict(params)

    def merge_block(pblk: Dict, lblk: Dict) -> Dict:
        out = dict(pblk)
        for name, entry in lblk.items():
            out[name] = L.merge_lora_into_dense(pblk[name], entry)
        return out

    with torch.no_grad():
        for tower in ("text", "vision"):
            if tower in lora:
                merged[tower] = dict(params[tower])
                merged[tower]["blocks"] = [
                    merge_block(p, l) for p, l in
                    zip(params[tower]["blocks"], lora[tower]["blocks"])]
        if "projector" in lora:
            merged["projector"] = merge_block(params["projector"],
                                              lora["projector"])
    return merged


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Tensor leaves of a nested dict/list tree (adapters, params), in tree
    order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def num_lora_params(lora: Dict) -> int:
    """Adapter weights (the ``a`` and ``b`` matrices; scales excluded)."""
    return sum(int(x.numel()) for x in tree_leaves(lora) if x.dim() >= 2)


def to_numpy(tree: Any):
    """A tree of tensors as nested dicts / lists of numpy arrays on the
    host (bf16 as float32: numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    x = tree.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


def save_lora(lora: Dict, path: str) -> None:
    """Pickle the adapter tree as nested dicts/lists of numpy arrays."""
    with open(path, "wb") as f:
        pickle.dump(to_numpy(lora), f)


def load_lora(path: str, device="cuda",
              dtype: Optional[torch.dtype] = None) -> Dict:
    """Load an adapter pickle (written by this package or the JAX one) onto
    ``device``, optionally cast to ``dtype``. Unpickling runs code: load
    only files this program or the JAX package wrote."""
    with open(path, "rb") as f:
        host = pickle.load(f)
    return from_jax_lora(host, device, dtype)
