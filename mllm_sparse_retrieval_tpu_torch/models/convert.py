"""HF checkpoint -> the port's parameter tree (the JAX package's
``models/convert.py``, without ``transformers``).

``convert_hf_dir`` reads a Hugging Face LLaVA / LLaVA-NeXT / Qwen2.5-VL /
InternVL checkpoint directory (``config.json`` and ``*.safetensors``, one
file or the shards that ``model.safetensors.index.json`` names) and
writes the framework
checkpoint both packages load: ``params.pkl``, a pickled tree of f32 numpy
arrays in the JAX package's layout, ``arch.json``, the architecture
manifest derived from ``config.json``, and the tokenizer files present.
The safetensors format is read directly (an 8-byte little-endian header
length, a JSON header of dtype, shape and byte offsets, raw little-endian
tensors), one tensor at a time through ``numpy.memmap``, widened to f32
exactly as torch's ``.float()`` widens F16 and BF16.

Conventions translated (as in the JAX package):
- ``nn.Linear`` stores ``[out, in]``; the tree holds ``[in, out]``;
- CLIP's conv patch embedding ``[H, C, P, P]`` becomes the patchify matmul
  weight ``[P*P*C, H]`` with (row, col, channel) flattening;
- CLIP's separate q/k/v projections are fused into one ``qkv``;
- Qwen's conv3d patch embedding ``[D, C, T, P, P]`` becomes ``[C*T*P*P,
  D]`` (the ``qwen_vl.patchify`` feature order); InternViT's conv keeps
  its bias and its position embedding loses the leading 1;
- both HF key layouts resolve: the hub's (``language_model.model.*`` /
  ``language_model.lm_head``; Qwen2.5-VL's ``visual.*`` / ``model.*``)
  and transformers >= 4.52's ``model.language_model.*`` / ``lm_head``.

``load_converted`` loads such a checkpoint onto a torch device.

    python -m mllm_sparse_retrieval_tpu_torch.models.convert <hf_dir> <out_dir>
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import struct
from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "special_tokens_map.json", "tokenizer.model")


def _t(x) -> np.ndarray:
    """A state-dict entry as a numpy f32 array."""
    return np.asarray(x, dtype=np.float32)


def _linear(sd: Mapping, prefix: str, transpose: bool = True) -> Dict:
    out = {"w": _t(sd[f"{prefix}.weight"]).T if transpose
           else _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["b"] = _t(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"])}


def _rmsnorm(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _t(sd[f"{prefix}.weight"])}


def convert_llava_state_dict(sd: Mapping, num_vision_layers: int,
                             num_text_layers: int,
                             patch_size: int) -> Dict:
    """Map an HF Llava*ForConditionalGeneration state dict (numpy arrays,
    or anything ``np.asarray`` takes) to the tree of numpy f32 arrays."""
    # transformers >= 4.52 moved submodules under model.* and hoisted lm_head;
    # resolve module *prefixes* against whichever layout the checkpoint uses.
    def k(prefix: str) -> str:
        candidates = [prefix, f"model.{prefix}"]
        if prefix.startswith("language_model.model."):
            rest = prefix[len("language_model.model."):]
            candidates += [f"model.language_model.{rest}",
                           f"language_model.{rest}"]
        if prefix.startswith("language_model.lm_head"):
            candidates.append("lm_head" + prefix[len("language_model.lm_head"):])
        for cand in candidates:
            if cand in sd or f"{cand}.weight" in sd:
                return cand
        raise KeyError(prefix)

    vt = "vision_tower.vision_model"

    # --- vision tower ---
    conv = _t(sd[k(f"{vt}.embeddings.patch_embedding.weight")])  # [H, C, P, P]
    h = conv.shape[0]
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, h)          # [(P,P,C), H]
    vision = {
        "patch_embed": {"w": patch_w},
        "cls_token": _t(sd[k(f"{vt}.embeddings.class_embedding")]).reshape(-1),
        "pos_embed": _t(sd[k(f"{vt}.embeddings.position_embedding.weight")]),
        "pre_ln": _layernorm(sd, k(f"{vt}.pre_layrnorm")),
        "blocks": [],
    }
    for i in range(num_vision_layers):
        p = f"{vt}.encoder.layers.{i}"
        q = _linear(sd, k(f"{p}.self_attn.q_proj"))
        kk_ = _linear(sd, k(f"{p}.self_attn.k_proj"))
        v = _linear(sd, k(f"{p}.self_attn.v_proj"))
        qkv = {"w": np.concatenate([q["w"], kk_["w"], v["w"]], axis=1)}
        if "b" in q:
            qkv["b"] = np.concatenate([q["b"], kk_["b"], v["b"]])
        vision["blocks"].append({
            "ln1": _layernorm(sd, k(f"{p}.layer_norm1")),
            "qkv": qkv,
            "out": _linear(sd, k(f"{p}.self_attn.out_proj")),
            "ln2": _layernorm(sd, k(f"{p}.layer_norm2")),
            "fc1": _linear(sd, k(f"{p}.mlp.fc1")),
            "fc2": _linear(sd, k(f"{p}.mlp.fc2")),
        })

    # --- projector ---
    projector = {
        "fc1": _linear(sd, k("multi_modal_projector.linear_1")),
        "fc2": _linear(sd, k("multi_modal_projector.linear_2")),
    }

    # --- language model ---
    lm = "language_model.model"
    text = {
        "embed": _t(sd[k(f"{lm}.embed_tokens.weight")]),
        "final_norm": _rmsnorm(sd, k(f"{lm}.norm")),
        "blocks": [],
    }
    for i in range(num_text_layers):
        p = f"{lm}.layers.{i}"
        text["blocks"].append({
            "attn_norm": _rmsnorm(sd, k(f"{p}.input_layernorm")),
            "q": _linear(sd, k(f"{p}.self_attn.q_proj")),
            "k": _linear(sd, k(f"{p}.self_attn.k_proj")),
            "v": _linear(sd, k(f"{p}.self_attn.v_proj")),
            "o": _linear(sd, k(f"{p}.self_attn.o_proj")),
            "mlp_norm": _rmsnorm(sd, k(f"{p}.post_attention_layernorm")),
            "gate": _linear(sd, k(f"{p}.mlp.gate_proj")),
            "up": _linear(sd, k(f"{p}.mlp.up_proj")),
            "down": _linear(sd, k(f"{p}.mlp.down_proj")),
        })
    try:
        text["lm_head"] = _linear(sd, k("language_model.lm_head"))
    except KeyError:
        pass  # tied embeddings

    params = {"vision": vision, "projector": projector, "text": text}
    # LLaVA-NeXT anyres models carry a learned newline embedding appended to
    # each unpadded feature row (HF ``pack_image_features``).
    for cand in ("image_newline", "model.image_newline"):
        if cand in sd:
            params["image_newline"] = _t(sd[cand]).reshape(-1)
            break
    return params


def _resolve(sd: Mapping, prefix: str) -> str:
    """The key prefix under which ``sd`` holds module ``prefix`` (written in
    transformers >= 4.52's ``state_dict()`` layout minus its ``model.``):
    that layout (``model.visual.*``, ``model.language_model.*``,
    ``model.vision_tower.*``, ``lm_head``), the unprefixed one, or the
    hub's shards of the chat-template families (Qwen2.5-VL:
    ``visual.*``, ``model.layers.*``; HF-integrated InternVL:
    ``language_model.model.*``, ``language_model.lm_head``)."""
    candidates = [prefix, f"model.{prefix}"]
    if prefix.startswith("language_model."):
        rest = prefix[len("language_model."):]
        candidates += [f"model.{rest}", f"language_model.model.{rest}"]
    if prefix == "lm_head":
        candidates.append("language_model.lm_head")
    for cand in candidates:
        if cand in sd or f"{cand}.weight" in sd:
            return cand
    raise KeyError(prefix)


def convert_qwen25vl_state_dict(sd: Mapping, num_vision_layers: int,
                                num_text_layers: int) -> Dict:
    """Map an HF Qwen2_5_VLForConditionalGeneration state dict to the tree
    of numpy f32 arrays in ``models/qwen_vl.py``'s layout (both key
    layouts, see ``_resolve``)."""

    def k(prefix: str) -> str:
        return _resolve(sd, prefix)

    conv = _t(sd[k("visual.patch_embed.proj.weight")])  # [D, C, T, P, P]
    d = conv.shape[0]
    vision = {
        # flatten order (C, T, Py, Px) matches qwen_vl.patchify features
        "patch_embed": {"w": conv.reshape(d, -1).T},
        "merger": {
            "ln_q": _rmsnorm(sd, k("visual.merger.ln_q")),
            "fc1": _linear(sd, k("visual.merger.mlp.0")),
            "fc2": _linear(sd, k("visual.merger.mlp.2")),
        },
        "blocks": [],
    }
    for i in range(num_vision_layers):
        p = f"visual.blocks.{i}"
        vision["blocks"].append({
            "norm1": _rmsnorm(sd, k(f"{p}.norm1")),
            "norm2": _rmsnorm(sd, k(f"{p}.norm2")),
            "qkv": _linear(sd, k(f"{p}.attn.qkv")),
            "proj": _linear(sd, k(f"{p}.attn.proj")),
            "gate": _linear(sd, k(f"{p}.mlp.gate_proj")),
            "up": _linear(sd, k(f"{p}.mlp.up_proj")),
            "down": _linear(sd, k(f"{p}.mlp.down_proj")),
        })

    lm = "language_model"
    text = {
        "embed": _t(sd[k(f"{lm}.embed_tokens.weight")]),
        "final_norm": _rmsnorm(sd, k(f"{lm}.norm")),
        "blocks": [],
    }
    for i in range(num_text_layers):
        p = f"{lm}.layers.{i}"
        text["blocks"].append({
            "attn_norm": _rmsnorm(sd, k(f"{p}.input_layernorm")),
            "q": _linear(sd, k(f"{p}.self_attn.q_proj")),
            "k": _linear(sd, k(f"{p}.self_attn.k_proj")),
            "v": _linear(sd, k(f"{p}.self_attn.v_proj")),
            "o": _linear(sd, k(f"{p}.self_attn.o_proj")),
            "mlp_norm": _rmsnorm(sd, k(f"{p}.post_attention_layernorm")),
            "gate": _linear(sd, k(f"{p}.mlp.gate_proj")),
            "up": _linear(sd, k(f"{p}.mlp.up_proj")),
            "down": _linear(sd, k(f"{p}.mlp.down_proj")),
        })
    try:
        text["lm_head"] = _linear(sd, k("lm_head"))
    except KeyError:
        pass  # tied embeddings
    return {"vision": vision, "text": text}


def convert_internvl_state_dict(sd: Mapping, num_vision_layers: int,
                                num_text_layers: int,
                                use_qk_norm: bool = False,
                                norm_type: str = "layer_norm") -> Dict:
    """Map an HF InternVLForConditionalGeneration state dict to the tree
    of numpy f32 arrays in ``models/internvl.py``'s layout (both key
    layouts, see ``_resolve``)."""

    def k(prefix: str) -> str:
        return _resolve(sd, prefix)

    def norm(prefix: str) -> Dict:
        if norm_type == "rms_norm":
            return _rmsnorm(sd, prefix)
        return _layernorm(sd, prefix)

    vt = "vision_tower"
    conv = _t(sd[k(f"{vt}.embeddings.patch_embeddings.projection.weight")])
    h = conv.shape[0]
    vision = {
        "patch_embed": {
            "w": conv.transpose(2, 3, 1, 0).reshape(-1, h),
            "b": _t(sd[k(
                f"{vt}.embeddings.patch_embeddings.projection.bias")]),
        },
        "cls_token": _t(sd[k(f"{vt}.embeddings.cls_token")]).reshape(-1),
        "pos_embed": _t(sd[k(f"{vt}.embeddings.position_embeddings")])[0],
        "blocks": [],
    }
    for i in range(num_vision_layers):
        p = f"{vt}.encoder.layer.{i}"
        blk = {
            "norm1": norm(k(f"{p}.layernorm_before")),
            "norm2": norm(k(f"{p}.layernorm_after")),
            "q": _linear(sd, k(f"{p}.attention.q_proj")),
            "k": _linear(sd, k(f"{p}.attention.k_proj")),
            "v": _linear(sd, k(f"{p}.attention.v_proj")),
            "proj": _linear(sd, k(f"{p}.attention.projection_layer")),
            "fc1": _linear(sd, k(f"{p}.mlp.fc1")),
            "fc2": _linear(sd, k(f"{p}.mlp.fc2")),
            "lambda1": _t(sd[k(f"{p}.lambda_1")]),
            "lambda2": _t(sd[k(f"{p}.lambda_2")]),
        }
        if use_qk_norm:
            blk["q_norm"] = _rmsnorm(sd, k(f"{p}.attention.q_norm"))
            blk["k_norm"] = _rmsnorm(sd, k(f"{p}.attention.k_norm"))
        vision["blocks"].append(blk)

    projector = {
        "ln": _layernorm(sd, k("multi_modal_projector.layer_norm")),
        "fc1": _linear(sd, k("multi_modal_projector.linear_1")),
        "fc2": _linear(sd, k("multi_modal_projector.linear_2")),
    }

    lm = "language_model"
    text = {
        "embed": _t(sd[k(f"{lm}.embed_tokens.weight")]),
        "final_norm": _rmsnorm(sd, k(f"{lm}.norm")),
        "blocks": [],
    }
    for i in range(num_text_layers):
        p = f"{lm}.layers.{i}"
        text["blocks"].append({
            "attn_norm": _rmsnorm(sd, k(f"{p}.input_layernorm")),
            "q": _linear(sd, k(f"{p}.self_attn.q_proj")),
            "k": _linear(sd, k(f"{p}.self_attn.k_proj")),
            "v": _linear(sd, k(f"{p}.self_attn.v_proj")),
            "o": _linear(sd, k(f"{p}.self_attn.o_proj")),
            "mlp_norm": _rmsnorm(sd, k(f"{p}.post_attention_layernorm")),
            "gate": _linear(sd, k(f"{p}.mlp.gate_proj")),
            "up": _linear(sd, k(f"{p}.mlp.up_proj")),
            "down": _linear(sd, k(f"{p}.mlp.down_proj")),
        })
    try:
        text["lm_head"] = _linear(sd, k("lm_head"))
    except KeyError:
        pass
    return {"vision": vision, "projector": projector, "text": text}


# ---------------------------------------------------------------------------
# Architecture manifests: the arch dataclass derived from the checkpoint's
# config.json is written as ``arch.json`` beside ``params.pkl``, in the JAX
# package's format, so either package rebuilds the checkpoint's true dims.
# ---------------------------------------------------------------------------

def arch_to_manifest(arch) -> Dict:
    """Serialize an arch dataclass (``MLLMConfig``, ``QwenVLConfig`` or
    ``InternVLConfig``) to a JSON-able manifest tagged with its kind."""
    from mllm_sparse_retrieval_tpu_torch.models.internvl import (
        InternVLConfig)
    from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
    from mllm_sparse_retrieval_tpu_torch.models.qwen_vl import QwenVLConfig

    kinds = {MLLMConfig: "mllm", QwenVLConfig: "qwen2_5_vl",
             InternVLConfig: "internvl"}
    kind = kinds.get(type(arch))
    if kind is None:
        raise TypeError(f"unknown arch type {type(arch)}")
    return {"kind": kind, "config": dataclasses.asdict(arch)}


def _tuples(v):
    """JSON lists back to the tuples the frozen configs carry
    (``grid_pinpoints``, ``mrope_section``, ``fullatt_block_indexes``)."""
    if isinstance(v, list):
        return tuple(tuple(e) if isinstance(e, list) else e for e in v)
    return v


def _dataclass_from_dict(cls, d: Dict):
    return cls(**{f.name: _tuples(d[f.name])
                  for f in dataclasses.fields(cls) if f.name in d})


def arch_from_manifest(manifest: Dict):
    from mllm_sparse_retrieval_tpu_torch.models.internvl import (
        InternViTConfig, InternVLConfig)
    from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
    from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
    from mllm_sparse_retrieval_tpu_torch.models.qwen_vl import (
        QwenViTConfig, QwenVLConfig)
    from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig

    classes = {"mllm": (MLLMConfig, ViTConfig),
               "qwen2_5_vl": (QwenVLConfig, QwenViTConfig),
               "internvl": (InternVLConfig, InternViTConfig)}
    kind = manifest["kind"]
    if kind not in classes:
        raise ValueError(f"unknown manifest kind {kind!r}")
    arch_cls, vision_cls = classes[kind]
    cfg = dict(manifest["config"])
    text = _dataclass_from_dict(LlamaConfig, cfg.pop("text"))
    vision = _dataclass_from_dict(vision_cls, cfg.pop("vision"))
    return arch_cls(vision=vision, text=text,
                    **{k: _tuples(v) for k, v in cfg.items()})


def _text_cfg_from_hf(tc: Dict, mrope: bool = False):
    from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig

    sec = None
    if mrope:
        rs = tc.get("rope_scaling") or {}
        if rs.get("mrope_section"):
            sec = tuple(rs["mrope_section"])
    return LlamaConfig(
        vocab_size=tc["vocab_size"],
        hidden_size=tc["hidden_size"],
        num_layers=tc["num_hidden_layers"],
        num_heads=tc["num_attention_heads"],
        num_kv_heads=tc.get("num_key_value_heads",
                            tc["num_attention_heads"]),
        intermediate_size=tc["intermediate_size"],
        max_seq_len=tc.get("max_position_embeddings", 4096),
        rope_theta=float(tc.get("rope_theta", 10000.0)),
        rms_eps=float(tc.get("rms_norm_eps", 1e-5)),
        qkv_bias=bool(tc.get("attention_bias", False)) or
        tc.get("model_type") in ("qwen2", "qwen2_5_vl_text"),
        tie_lm_head=bool(tc.get("tie_word_embeddings", False)),
        mrope_section=sec,
    )


def arch_from_hf_config(hf_cfg: Dict):
    """The arch dataclass of a checkpoint's ``config.json`` dict: LLaVA-1.5
    (``llava``), LLaVA-NeXT / 1.6 / E5-V (``llava_next``), Qwen2.5-VL at
    any size (``qwen2_5_vl``) and HF-integrated InternVL (``internvl``)."""
    from mllm_sparse_retrieval_tpu_torch.models.internvl import (
        InternViTConfig, InternVLConfig)
    from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
    from mllm_sparse_retrieval_tpu_torch.models.qwen_vl import (
        QwenViTConfig, QwenVLConfig)
    from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig

    mt = hf_cfg.get("model_type")
    if mt in ("llava", "llava_next"):
        vc = hf_cfg["vision_config"]
        vision = ViTConfig(
            image_size=vc["image_size"], patch_size=vc["patch_size"],
            hidden_size=vc["hidden_size"],
            num_layers=vc["num_hidden_layers"],
            num_heads=vc["num_attention_heads"],
            mlp_ratio=vc.get("intermediate_size",
                             4 * vc["hidden_size"]) // vc["hidden_size"],
            feature_layer=hf_cfg.get("vision_feature_layer", -2),
            act=vc.get("hidden_act", "quick_gelu"),
        )
        pinpoints = tuple(
            tuple(p) for p in hf_cfg.get("image_grid_pinpoints") or ())
        return MLLMConfig(
            vision=vision, text=_text_cfg_from_hf(hf_cfg["text_config"]),
            image_token_id=hf_cfg.get("image_token_index",
                                      hf_cfg.get("image_token_id")),
            grid_pinpoints=pinpoints if mt == "llava_next" else (),
        )
    if mt == "qwen2_5_vl":
        vc = hf_cfg["vision_config"]
        # older HF configs inline the text fields at the top level
        tc = hf_cfg.get("text_config") or hf_cfg
        vision = QwenViTConfig(
            hidden_size=vc["hidden_size"], depth=vc["depth"],
            num_heads=vc["num_heads"],
            intermediate_size=vc["intermediate_size"],
            out_hidden_size=vc["out_hidden_size"],
            patch_size=vc["patch_size"],
            temporal_patch_size=vc.get("temporal_patch_size", 2),
            spatial_merge_size=vc.get("spatial_merge_size", 2),
            window_size=vc.get("window_size", 112),
            fullatt_block_indexes=tuple(
                vc.get("fullatt_block_indexes", (7, 15, 23, 31))),
        )
        return QwenVLConfig(
            vision=vision, text=_text_cfg_from_hf(tc, mrope=True),
            image_token_id=hf_cfg.get("image_token_id", 151655),
            vision_start_token_id=hf_cfg.get("vision_start_token_id", 151652),
            native_resolution=True,
        )
    if mt == "internvl":
        vc = hf_cfg["vision_config"]
        vision = InternViTConfig(
            hidden_size=vc["hidden_size"],
            num_layers=vc["num_hidden_layers"],
            num_heads=vc["num_attention_heads"],
            intermediate_size=vc["intermediate_size"],
            image_size=vc["image_size"] if isinstance(vc["image_size"], int)
            else vc["image_size"][0],
            patch_size=vc["patch_size"] if isinstance(vc["patch_size"], int)
            else vc["patch_size"][0],
            norm_type=vc.get("norm_type", "layer_norm"),
            use_qk_norm=bool(vc.get("use_qk_norm", False)),
        )
        return InternVLConfig(
            vision=vision, text=_text_cfg_from_hf(hf_cfg["text_config"]),
            image_token_id=hf_cfg.get("image_token_id", 151667),
            downsample_ratio=float(hf_cfg.get("downsample_ratio", 0.5)),
        )
    raise ValueError(
        f"unsupported HF model_type {mt!r} — supported: llava, llava_next, "
        f"qwen2_5_vl, internvl")


# ---------------------------------------------------------------------------
# safetensors, read without the safetensors package
# ---------------------------------------------------------------------------

# the dtypes read, as numpy little-endian storage types
_ST_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2"}


def _safetensors_header(path: str) -> Tuple[int, Dict]:
    """``(offset of the data block, {name: {dtype, shape, data_offsets}})``."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return 8 + n, header


def _read_tensor(path: str, data_start: int, entry: Dict) -> np.ndarray:
    """One tensor as f32: F32 copied, F16 widened, BF16 shifted into the
    high half of a uint32 (torch's ``.float()``, bit for bit)."""
    dt = entry["dtype"]
    if dt not in _ST_DTYPES:
        raise ValueError(f"{path}: tensor dtype {dt} is not read (F32, F16 "
                         f"and BF16 are)")
    shape = tuple(entry["shape"])
    n = int(np.prod(shape, dtype=np.int64))
    begin, end = entry["data_offsets"]
    if end - begin != n * np.dtype(_ST_DTYPES[dt]).itemsize:
        raise ValueError(f"{path}: {end - begin} bytes for a {dt} tensor of "
                         f"shape {list(shape)}")
    if n == 0:
        return np.zeros(shape, np.float32)
    raw = np.memmap(path, dtype=_ST_DTYPES[dt], mode="r",
                    offset=data_start + begin, shape=(n,))
    if dt == "BF16":
        out = np.array(raw, dtype=np.uint32)
        out <<= 16
        out = out.view(np.float32)
    else:
        out = np.array(raw, dtype=np.float32)
    del raw
    return out.reshape(shape)


class SafetensorsStateDict(Mapping):
    """The state dict of an HF checkpoint directory: ``model.safetensors``,
    or the shards that ``model.safetensors.index.json``'s ``weight_map``
    names. Only headers are read up front; each access reads that tensor
    from its file (a fresh f32 array)."""

    def __init__(self, hf_dir: str):
        index = os.path.join(hf_dir, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
        else:
            files = ["model.safetensors"]
        self._entries: Dict[str, tuple] = {}
        for name in files:
            path = os.path.join(hf_dir, name)
            start, header = _safetensors_header(path)
            for key, entry in header.items():
                self._entries[key] = (path, start, entry)

    def alias(self, key: str, target: str) -> None:
        """Let ``key`` read ``target``'s tensor (a tied weight, which HF
        saves once but lists under both names in ``state_dict()``)."""
        self._entries[key] = self._entries[target]

    def __getitem__(self, key: str) -> np.ndarray:
        return _read_tensor(*self._entries[key])

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


_LARGE_BYTES = 1 << 16


def _large(obj) -> bool:
    return type(obj) is bytes and len(obj) >= _LARGE_BYTES


class _TreePickler(pickle._Pickler):
    """``pickle.dump``'s bytes (protocol 4), holding no array's data after
    writing it. A pickler's memo keeps every memoized object alive until
    the dump ends, and each array's ``__reduce__`` makes a bytes copy of
    its data, memoized with its state tuple: the C pickler so holds a
    second copy of the whole tree (33.4 GB for LLaVA-NeXT-8B in f32). Here
    those objects still get their MEMOIZE opcode, so the stream is the same,
    but the memo keeps no reference to them: they are written once and
    never referred to again.

    It relies on CPython internals: ``pickle._Pickler`` is the pure-Python
    pickler, ``memoize`` and ``put`` its private methods, and the memo a
    dict of ``id(obj) -> (index, obj)``. The byte-equality test against
    ``pickle.dump`` (``tests/test_torch_convert.py``) guards them."""

    def memoize(self, obj):
        if _large(obj) or (type(obj) is tuple and any(map(_large, obj))):
            idx = len(self.memo)
            self.write(self.put(idx))
            self.memo[(idx,)] = (idx, None)    # a key no id() can equal
            return
        super().memoize(obj)


_EMBED_KEYS = ("language_model.model.embed_tokens.weight",
               "model.language_model.embed_tokens.weight",
               "model.embed_tokens.weight",
               "language_model.embed_tokens.weight")


def convert_hf_dir(hf_dir: str, out_dir: str) -> None:
    """Convert a local HF checkpoint directory of any supported family and
    size into a framework checkpoint dir: ``params.pkl`` + ``arch.json``
    (dims from ``config.json``) + the tokenizer files present, and, for a
    sentencepiece ``tokenizer.model`` without ``tokenizer.json``, the
    ``tokenizer.json`` ``transformers`` converts it to (the JAX
    converter's ``save_pretrained`` writes the same dict)."""
    with open(os.path.join(hf_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    arch = arch_from_hf_config(hf_cfg)
    mt = hf_cfg["model_type"]
    sd = SafetensorsStateDict(hf_dir)
    if arch.text.tie_lm_head and not any(
            h in sd for h in ("lm_head.weight",
                              "language_model.lm_head.weight")):
        sd.alias("lm_head.weight", next(e for e in _EMBED_KEYS if e in sd))
    if mt == "qwen2_5_vl":
        params = convert_qwen25vl_state_dict(sd, arch.vision.depth,
                                             arch.text.num_layers)
    elif mt == "internvl":
        params = convert_internvl_state_dict(
            sd, arch.vision.num_layers, arch.text.num_layers,
            use_qk_norm=arch.vision.use_qk_norm,
            norm_type=arch.vision.norm_type)
    else:
        params = convert_llava_state_dict(sd, arch.vision.num_layers,
                                          arch.text.num_layers,
                                          arch.vision.patch_size)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "params.pkl"), "wb") as f:
        _TreePickler(f, protocol=4).dump(params)
    with open(os.path.join(out_dir, "arch.json"), "w") as f:
        json.dump(arch_to_manifest(arch), f, indent=1)
    for name in _TOKENIZER_FILES:
        src = os.path.join(hf_dir, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(out_dir, name))
    if os.path.exists(os.path.join(hf_dir, "tokenizer.model")) and \
            not os.path.exists(os.path.join(hf_dir, "tokenizer.json")):
        from mllm_sparse_retrieval_tpu_torch.models.hf_tokenizer import (
            _read_json, tokenizer_json_of_dir)

        data = tokenizer_json_of_dir(
            hf_dir, _read_json(os.path.join(hf_dir, "tokenizer_config.json")),
            _read_json(os.path.join(hf_dir, "special_tokens_map.json")))
        with open(os.path.join(out_dir, "tokenizer.json"), "w",
                  encoding="utf-8") as f:
            json.dump(data, f, ensure_ascii=False, indent=2)


def convert_hf_llava_dir(hf_dir: str, out_path: str, num_vision_layers: int,
                         num_text_layers: int, patch_size: int) -> None:
    """Convert a local HF LLaVA checkpoint to one pickled param tree at
    ``out_path`` (the legacy single-file form; ``convert_hf_dir`` writes a
    directory). The shards are read as ``SafetensorsStateDict`` reads
    them, a tied LM head from the embedding."""
    sd = SafetensorsStateDict(hf_dir)
    if not any(h in sd for h in ("lm_head.weight",
                                 "language_model.lm_head.weight")):
        sd.alias("lm_head.weight", next(e for e in _EMBED_KEYS if e in sd))
    params = convert_llava_state_dict(sd, num_vision_layers,
                                      num_text_layers, patch_size)
    with open(out_path, "wb") as f:
        _TreePickler(f, protocol=4).dump(params)


def _to_device(tree, device: torch.device, dtype: torch.dtype):
    """Replace each numpy leaf of ``tree`` (dicts and lists, in place) by a
    contiguous tensor on ``device``, floating leaves in ``dtype``. A leaf's
    host array is dropped as soon as its tensor exists, so host memory stays
    near the pickle's size."""
    keys = list(tree) if isinstance(tree, dict) else range(len(tree))
    for key in keys:
        leaf = tree[key]
        if isinstance(leaf, (dict, list)):
            _to_device(leaf, device, dtype)
            continue
        t = torch.from_numpy(np.asarray(leaf)).to(device)
        if t.is_floating_point():
            t = t.to(dtype)
        tree[key] = t.contiguous()
        del leaf, t
    return tree


def _hf_tokenizer(ckpt_dir: str):
    """The directory's tokenizer: an ``HFJsonTokenizer`` over its
    ``tokenizer.json`` (with ``tokenizer_config.json``,
    ``special_tokens_map.json`` and ``chat_template.jinja``), or over the
    ``tokenizer.json`` its sentencepiece ``tokenizer.model`` converts to
    where it has no ``tokenizer.json`` (``models/sentencepiece.py``); None
    when it has no tokenizer file at all, as in the JAX package."""
    if not any(os.path.exists(os.path.join(ckpt_dir, n))
               for n in _TOKENIZER_FILES):
        return None
    from mllm_sparse_retrieval_tpu_torch.models.hf_tokenizer import (
        HFJsonTokenizer)
    return HFJsonTokenizer.from_dir(ckpt_dir)


def load_converted(checkpoint_path: str, spec=None,
                   dtype: torch.dtype = torch.float32, device="cuda"
                   ) -> Tuple[Dict, Optional[object], Optional[object]]:
    """Load a converted checkpoint (``params.pkl``, optional ``arch.json``
    manifest and tokenizer files) written by either package.

    ``checkpoint_path`` is the directory or its ``.pkl`` file. Returns
    ``(params, tokenizer_or_None, arch_or_None)``: the tree of tensors on
    ``device`` in the port's layout (the JAX tree's, as
    ``convert_jax.from_jax_params`` gives it), the tokenizer when the
    directory has one (read from its ``tokenizer.json``, or its
    sentencepiece ``tokenizer.model``, by ``hf_tokenizer.HFJsonTokenizer``,
    no ``transformers``), and the
    manifest's arch, which carries the checkpoint's true dims. ``spec`` is unused, as
    in the JAX package."""
    params_file = checkpoint_path if checkpoint_path.endswith(".pkl") \
        else os.path.join(checkpoint_path, "params.pkl")
    with open(params_file, "rb") as f:
        host = pickle.load(f)
    params = _to_device(host, torch.device(device), dtype)
    del host

    ckpt_dir = os.path.dirname(params_file)
    arch = None
    manifest_path = os.path.join(ckpt_dir, "arch.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            arch = arch_from_manifest(json.load(f))
    return params, _hf_tokenizer(ckpt_dir), arch


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert an HF checkpoint directory to a framework "
                    "checkpoint (params.pkl + arch.json + tokenizer)")
    ap.add_argument("hf_dir")
    ap.add_argument("out_dir")
    args = ap.parse_args()
    convert_hf_dir(args.hf_dir, args.out_dir)
    print(args.out_dir)
