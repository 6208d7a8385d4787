"""A configuration file's published widths, the port's arch for it, and
the check that the two agree.

A configuration file holds its source's ``config.json`` keys under their
own names (Qwen2.5-VL's at the top level with ``vision_config``;
InternVL2.5's ``llm_config`` and ``vision_config``), the registry function
of the port that builds the arch, and the chat template's special tokens,
which the drawn tokenizer gives other ids than the published ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


def text_config(config: dict) -> dict:
    """The language model's keys of a configuration file."""
    return config.get("llm_config", config)


def _expected(config: dict) -> List[Tuple[str, object]]:
    """(port arch attribute path, published value) pairs."""
    t = text_config(config)
    v = config["vision_config"]
    pairs = [
        ("text.vocab_size", t["vocab_size"]),
        ("text.hidden_size", t["hidden_size"]),
        ("text.num_layers", t["num_hidden_layers"]),
        ("text.num_heads", t["num_attention_heads"]),
        ("text.num_kv_heads", t["num_key_value_heads"]),
        ("text.intermediate_size", t["intermediate_size"]),
        ("text.rope_theta", t["rope_theta"]),
        ("text.rms_eps", t["rms_norm_eps"]),
        ("text.tie_lm_head", t["tie_word_embeddings"]),
    ]
    if config["family"] == "qwen2_5_vl":
        pairs += [
            ("text.mrope_section", tuple(t["rope_scaling"]["mrope_section"])),
            ("vision.hidden_size", v["hidden_size"]),
            ("vision.depth", v["depth"]),
            ("vision.num_heads", v["num_heads"]),
            ("vision.intermediate_size", v["intermediate_size"]),
            ("vision.out_hidden_size", v["out_hidden_size"]),
            ("vision.patch_size", v["patch_size"]),
            ("vision.temporal_patch_size", v["temporal_patch_size"]),
            ("vision.spatial_merge_size", v["spatial_merge_size"]),
            ("vision.window_size", v["window_size"]),
            ("vision.fullatt_block_indexes",
             tuple(v["fullatt_block_indexes"])),
            ("min_pixels", config["min_pixels"]),
            ("max_pixels", config["max_pixels"]),
        ]
    else:
        pairs += [
            ("vision.hidden_size", v["hidden_size"]),
            ("vision.num_layers", v["num_hidden_layers"]),
            ("vision.num_heads", v["num_attention_heads"]),
            ("vision.intermediate_size", v["intermediate_size"]),
            ("vision.image_size", v["image_size"]),
            ("vision.patch_size", v["patch_size"]),
            ("vision.norm_type", v["norm_type"]),
            ("vision.use_qk_norm", v["qk_normalization"]),
            ("vision.layer_norm_eps", v["layer_norm_eps"]),
            ("downsample_ratio", config["downsample_ratio"]),
            ("max_dynamic_tiles", config["max_dynamic_patch"]),
        ]
    return pairs


def _get(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def mismatches(config: dict, arch) -> List[str]:
    out = []
    for path, want in _expected(config):
        got = _get(arch, path)
        if isinstance(got, float) or isinstance(want, float):
            same = float(got) == float(want)
        else:
            same = got == want
        if not same:
            out.append(f"{path}: port {got!r}, configuration {want!r}")
    return out


def port_arch(config: dict, special_ids: Dict[str, int]):
    """The port's arch for ``config``: its registry function's (with the
    file's ``arch_overrides``, which only the CPU tests' tiny files have),
    with the special tokens' ids set to the drawn tokenizer's; raises
    where a width, or a special token's id, differs from the
    configuration's."""
    from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig
    from mllm_sparse_retrieval_tpu_torch.models import registry

    fn = getattr(registry, config["registry"])
    if "registry_model_config" in config:
        arch = fn(ModelConfig(**config["registry_model_config"]))
    else:
        arch = fn()
    for key, val in config.get("arch_overrides", {}).items():
        if isinstance(val, dict):
            val = dataclasses.replace(getattr(arch, key), **{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in val.items()})
        arch = dataclasses.replace(arch, **{key: val})
    ids = {}
    bad = []
    for field, spec in config["special_tokens"].items():
        ids[field] = special_ids[spec["token"]]
        if ids[field] != config[spec["key"]]:
            bad.append(f"{spec['key']}: tokenizer {ids[field]}, "
                       f"configuration {config[spec['key']]}")
    arch = dataclasses.replace(arch, **ids)
    bad += mismatches(config, arch)
    if bad:
        raise ValueError(f"{config['name']}: the port's arch differs from "
                         f"the configuration: " + "; ".join(bad))
    return arch


def template(config: dict):
    from mllm_sparse_retrieval_tpu_torch.models import templates

    return getattr(templates, config["template"])
