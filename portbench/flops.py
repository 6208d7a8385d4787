"""Model FLOPs from a configuration's widths and real token counts.

A multiply-add is two FLOPs. Only real (non-pad) tokens count, and
attention only over the pairs a causal prompt's real tokens admit. The
LM head runs at one position a sequence (the representation's). What
padding, recompute or a kernel's extra work adds is not model work.
"""

from __future__ import annotations

from typing import Sequence


def _text(config: dict) -> dict:
    return config.get("llm_config", config)


def decoder_linear_params(config: dict) -> int:
    """Weights of one decoder layer's linear maps."""
    t = _text(config)
    h, ffn = t["hidden_size"], t["intermediate_size"]
    dh = h // t["num_attention_heads"]
    q = h * t["num_attention_heads"] * dh
    kv = 2 * h * t["num_key_value_heads"] * dh
    o = t["num_attention_heads"] * dh * h
    return q + kv + o + 3 * h * ffn


def decoder_forward(config: dict, lengths: Sequence[int],
                    head: bool = True) -> float:
    """FLOPs of the decoder and (with ``head``) the LM head over prompts of
    ``lengths`` real tokens (causal attention, the head at one position
    each)."""
    t = _text(config)
    layers, h = t["num_hidden_layers"], t["hidden_size"]
    tokens = sum(lengths)
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    linear = 2 * decoder_linear_params(config) * tokens
    attn = 4 * h * pairs            # q k and p v, all heads
    out = layers * (linear + attn)
    if head:
        out += 2 * h * t["vocab_size"] * len(lengths)
    return float(out)


def lora_train(config: dict, lengths: Sequence[int], rank: int) -> float:
    """FLOPs of the LoRA paths of a training step over prompts of
    ``lengths`` real tokens: on every linear map of every decoder layer,
    the forward ``(x A) B`` and its backward (the input's gradient and
    both factors'), three times the forward."""
    t = _text(config)
    h, ffn = t["hidden_size"], t["intermediate_size"]
    dh = h // t["num_attention_heads"]
    q, kv = t["num_attention_heads"] * dh, t["num_key_value_heads"] * dh
    dims = [(h, q), (h, kv), (h, kv), (q, h), (h, ffn), (h, ffn), (ffn, h)]
    per_token = sum(2 * rank * (i + o) for i, o in dims)
    return float(3 * t["num_hidden_layers"] * per_token * sum(lengths))


def qwen_vit(config: dict, gh: int, gw: int) -> float:
    """FLOPs of Qwen2.5-VL's windowed ViT and merger on one image of
    ``gh x gw`` patches: the real patches only, each window's attention
    over its own real patches."""
    v = config["vision_config"]
    c, ffn, m = v["hidden_size"], v["intermediate_size"], \
        v["spatial_merge_size"]
    p = v["patch_size"]
    s = gh * gw
    patch_dim = 3 * v["temporal_patch_size"] * p * p
    per_block = 2 * s * (c * 3 * c + c * c + 3 * c * ffn)
    lh, lw = gh // m, gw // m
    win = v["window_size"] // m // p
    window_pairs = 0
    for r in range(0, lh, win):
        for q in range(0, lw, win):
            units = min(win, lh - r) * min(win, lw - q)
            window_pairs += (units * m * m) ** 2
    full = set(v["fullatt_block_indexes"])
    attn = sum(4 * c * (s * s if i in full else window_pairs)
               for i in range(v["depth"]))
    units = lh * lw
    merged = m * m * c
    merger = 2 * units * (merged * merged + merged * v["out_hidden_size"])
    return float(2 * s * patch_dim * c + v["depth"] * per_block + attn
                 + merger)


def internvit(config: dict, tiles: int) -> float:
    """FLOPs of InternViT, the pixel shuffle's projector and nothing of the
    padding tiles, over ``tiles`` real tiles."""
    v = config["vision_config"]
    c, ffn = v["hidden_size"], v["intermediate_size"]
    grid = v["image_size"] // v["patch_size"]
    s = grid * grid + 1
    patch_dim = 3 * v["patch_size"] ** 2
    per_layer = 2 * s * (4 * c * c + 2 * c * ffn) + 4 * c * s * s
    shuffled = int(c / config["downsample_ratio"] ** 2)
    out = int(grid * config["downsample_ratio"]) ** 2
    th = _text(config)["hidden_size"]
    projector = 2 * out * (shuffled * th + th * th)
    return float(tiles * (2 * grid * grid * patch_dim * c
                          + v["num_hidden_layers"] * per_layer + projector))
