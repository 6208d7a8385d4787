"""Carry weights across from the JAX package's parameter tree.

The JAX llama tree (``embed``, ``blocks[i]``, ``final_norm``, ``lm_head``)
maps one to one onto the port's dicts, in the same ``[in, out]`` dense
orientation, so a test can run both models on the same weights; so do the
vision towers (the CLIP ViT, Qwen2.5-VL's windowed ViT with its
``merger``, InternViT), the projectors and the ``image_newline``
embedding, and so do LoRA adapter trees (``models/lora.py``). Arrays
arrive as numpy (the caller converts JAX arrays with ``np.asarray``). A
quantized JAX tree carries across too: each JAX ``QuantizedWeight`` (found
by its fields, the port imports nothing of the JAX package) becomes the
port's, with the same bytes and metadata, its scales kept f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.models.quantization import (
    QuantizedWeight)

_QUANT_FIELDS = ("q", "scale", "bits", "logical_shape", "scale_q",
                 "scale_off", "mode")


def _to_torch(tree: Any, device, dtype: Optional[torch.dtype]):
    if all(hasattr(tree, f) for f in _QUANT_FIELDS):
        def arr(x):
            return None if x is None else _to_torch(x, device, None)

        return QuantizedWeight(
            arr(tree.q), arr(tree.scale), int(tree.bits),
            tuple(int(d) for d in tree.logical_shape), arr(tree.scale_q),
            arr(tree.scale_off), str(tree.mode))
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_params(tree: Dict, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """Port params from a JAX tree of numpy arrays.

    ``tree`` is a JAX family tree (LLaVA: ``{"vision", "projector",
    "text"}`` and, for anyres configs, ``"image_newline"``; Qwen2.5-VL:
    ``{"vision", "text"}``; InternVL: ``{"vision", "projector", "text"}``)
    or a bare llama tree. Returns the same keys (``{"text": llama params}``
    for a bare tree) for the family's ``encode``.
    """
    text = tree["text"] if "text" in tree else tree
    missing = {"embed", "blocks", "final_norm"} - set(text)
    if missing:
        raise KeyError(f"not a llama parameter tree: missing {sorted(missing)}")
    device = torch.device(device)
    out = {"text": _to_torch(text, device, dtype)}
    if "text" in tree:
        for key in ("vision", "projector", "image_newline"):
            if key in tree:
                out[key] = _to_torch(tree[key], device, dtype)
    return out


def from_jax_lora(tree: Dict, device="cuda",
                  dtype: Optional[torch.dtype] = None) -> Dict:
    """Port a JAX LoRA adapter tree of numpy arrays (``{"text": {"blocks":
    [{"q": {"a", "b", "scale"}, ...}]}, "vision": ..., "projector": ...}``)
    to the port's tree of tensors, the same structure."""
    if "text" not in tree and "vision" not in tree \
            and "projector" not in tree:
        raise KeyError("not a LoRA adapter tree: no text, vision or "
                       "projector entry")
    return _to_torch(tree, torch.device(device), dtype)
