"""Qwen2.5-VL family: windowed ViT + M-RoPE decoder (the JAX package's
``models/qwen_vl.py``).

The HF implementation packs variable-size images into one ragged sequence
with ``cu_seqlens``; here every shape is static per family. The window
permutation, window masks, 2-D rotary tables and M-RoPE position ids are
host-computed numpy tables, as in the JAX package:

- conv3d patch embedding as a flattened-patch matmul (host ``patchify``
  reproduces the HF image processor's patch order: merge-unit-major
  sequence, (channel, temporal, py, px) features);
- RMSNorm pre-norm blocks, fused qkv with bias, 2-D rotary (h/w halves),
  window attention everywhere except ``fullatt_block_indexes``;
- spatial merge: RMSNorm + 2-layer GELU MLP over 2x2 merged units;
- decoder: ``models/llama.py`` with ``qkv_bias`` and ``mrope_section``
  (M-RoPE); 3-D position ids from ``mrope_position_ids`` (the image-and-text
  case of HF's ``get_rope_index``).

Two routes: a fixed square grid (``vision_apply``, the tiny family) and
native resolution (``vision_apply_native``, the registry's families), where
each image keeps its own smart-resized grid, padded to the family budget
with validity masks. Native preprocessing resizes with
``models.anyres.resize_bicubic``, equal to Pillow's BICUBIC bit for bit, so
the port needs no Pillow. The tower's attention is plain
``layers.attention``, chunked over the batch (``attention_chunked``): the
windowed blocks attend within 64-patch windows, the full-attention blocks
over the whole padded sequence (4,608 patches at the 7B budget). Prompts
stay under 1,024 tokens, so the decoder takes plain attention too.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.models import llama
from mllm_sparse_retrieval_tpu_torch.models import reps as R
from mllm_sparse_retrieval_tpu_torch.models.anyres import resize_bicubic
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import (
    splice_image_embeddings)
from mllm_sparse_retrieval_tpu_torch.tracing import span


@dataclass(frozen=True)
class QwenViTConfig:
    hidden_size: int = 1280
    depth: int = 32
    num_heads: int = 16
    intermediate_size: int = 3420
    out_hidden_size: int = 2048
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    in_channels: int = 3
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * \
            self.patch_size ** 2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


@dataclass(frozen=True)
class QwenVLConfig:
    vision: QwenViTConfig = field(default_factory=QwenViTConfig)
    text: LlamaConfig = field(default_factory=LlamaConfig)
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    grid_h: int = 16            # static patch grid (fixed-resolution mode)
    grid_w: int = 16
    # Native dynamic resolution (the HF processor's default behavior):
    # aspect-preserving smart-resize to a per-image grid within
    # [min_pixels, max_pixels], factor-28 rounding.
    # When False, pipelines pin the square grid above (tiny/debug mode).
    native_resolution: bool = False
    min_pixels: int = 4 * 28 * 28          # HF Qwen2VLImageProcessor default
    # pipeline pixel budget: bounds the one static vision shape. 768 merge
    # units (about 0.6 MP) keep typical photos (COCO/Flickr <= 640x480) at
    # native resolution; HF's 12.8 MP default would give a 65k-patch
    # batch. Raise for high-res corpora.
    max_pixels: int = 768 * 28 * 28

    @property
    def num_image_tokens(self) -> int:
        """Merged tokens the LLM sees per image (fixed-grid mode)."""
        m = self.vision.spatial_merge_size
        return (self.grid_h // m) * (self.grid_w // m)

    @property
    def resize_factor(self) -> int:
        return self.vision.patch_size * self.vision.spatial_merge_size

    @property
    def max_merge_units(self) -> int:
        """Max merged tokens an image can produce under ``max_pixels``
        (one merge unit covers ``resize_factor²`` pixels)."""
        return self.max_pixels // (self.resize_factor ** 2)

    @property
    def padded_window_units(self) -> int:
        """Static merge-unit budget INCLUDING window padding: uniform
        windows need each grid side rounded up to the window size, which
        inflates extreme aspect ratios; preprocessing shrinks any image
        whose padded grid would exceed this (see ``preprocess_native``)."""
        win = self.vision.window_size // self.vision.patch_size // \
            self.vision.spatial_merge_size
        u = self.max_merge_units
        budget = int(u * 1.5)
        return -(-budget // (win * win)) * (win * win)


# ---------------------------------------------------------------------------
# Host-side static layout (window permutation, masks, rotary tables)
# ---------------------------------------------------------------------------

def patchify(image: np.ndarray, cfg: QwenViTConfig) -> np.ndarray:
    """[H, W, 3] normalized image -> [S, patch_dim] flattened patches.

    Reproduces the HF Qwen2VL image-processor layout
    (image_processing_qwen2_vl.py): a single frame is repeated across the
    temporal patch, the patch sequence is merge-unit-major, features are
    ordered (channel, temporal, py, px).
    """
    p, m, t = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    h, w, c = image.shape
    gh, gw = h // p, w // p
    frames = np.repeat(image.transpose(2, 0, 1)[None], t, axis=0)  # [T, C, H, W]
    x = frames.reshape(1, t, c, gh // m, m, p, gw // m, m, p)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return np.ascontiguousarray(
        x.reshape(gh * gw, c * t * p * p)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def vision_layout(grid_h: int, grid_w: int, spatial_merge_size: int,
                  window_size: int, patch_size: int, head_dim: int,
                  rope_theta: float):
    """Static per-grid tables: window permutation of merge units, attention
    masks, rotary cos/sin. Mirrors ``get_window_index`` + ``rot_pos_emb``
    (modeling_qwen2_5_vl.py:336-404) for one image.

    Returns dict of numpy arrays:
      unit_perm   [U]      window-order permutation of merge units
      unit_inv    [U]      inverse permutation
      window_mask [S, S]   bool, same-window attend (in window order)
      cos, sin    [S, hd/2] rotary tables (in window order)
    """
    m = spatial_merge_size
    lh, lw = grid_h // m, grid_w // m
    win_units = window_size // m // patch_size  # merge units per window side

    # window permutation over merge units (llm grid), padding with -1
    index = np.arange(lh * lw).reshape(lh, lw)
    pad_h = (-lh) % win_units
    pad_w = (-lw) % win_units
    padded = np.full((lh + pad_h, lw + pad_w), -1, np.int64)
    padded[:lh, :lw] = index
    nwh, nww = (lh + pad_h) // win_units, (lw + pad_w) // win_units
    padded = padded.reshape(nwh, win_units, nww, win_units)
    padded = padded.transpose(0, 2, 1, 3).reshape(nwh * nww,
                                                  win_units * win_units)
    seqlens = (padded != -1).sum(axis=1)           # units per window
    unit_perm = padded.reshape(-1)
    unit_perm = unit_perm[unit_perm != -1]
    unit_inv = np.argsort(unit_perm)

    # same-window mask over patches (window order); windows are contiguous
    unit_window = np.repeat(np.arange(len(seqlens)), seqlens)     # [U]
    patch_window = np.repeat(unit_window, m * m)                  # [S]
    window_mask = patch_window[:, None] == patch_window[None, :]

    # 2-D rotary: per patch (h, w) position, merge-unit-major order
    hpos = np.arange(grid_h)[:, None].repeat(grid_w, 1)
    wpos = np.arange(grid_w)[None, :].repeat(grid_h, 0)

    def to_unit_major(pos):
        x = pos.reshape(lh, m, lw, m).transpose(0, 2, 1, 3)
        return x.reshape(-1)

    hpos, wpos = to_unit_major(hpos), to_unit_major(wpos)
    inv = 1.0 / (rope_theta ** (np.arange(0, head_dim // 2, 2, np.float32)
                                / (head_dim // 2)))
    freqs = np.concatenate(
        [hpos[:, None] * inv[None], wpos[:, None] * inv[None]], axis=1
    )                                                              # [S, hd/2]
    # reorder patches to window order
    patch_perm = (unit_perm[:, None] * (m * m) +
                  np.arange(m * m)[None]).reshape(-1)
    freqs = freqs[patch_perm]
    return {
        "unit_perm": unit_perm.astype(np.int32),
        "unit_inv": unit_inv.astype(np.int32),
        "patch_perm": patch_perm.astype(np.int32),
        "window_mask": window_mask,
        "cos": np.cos(freqs).astype(np.float32),
        "sin": np.sin(freqs).astype(np.float32),
    }


def mrope_position_ids(
    input_ids: np.ndarray,       # [B, T]
    attention_mask: np.ndarray,  # [B, T] (right padding)
    image_token_id: int,
    grid_thw,                    # (t, h, w) shared, or [B, 3] per example
    spatial_merge_size: int,
) -> np.ndarray:
    """[3, B, T] M-RoPE position ids — the image+text case of HF's
    ``get_rope_index`` (modeling_qwen2_5_vl.py). Text spans advance all three
    components together; an image block gets (t, h, w) grid indices offset by
    the running position; the next text token resumes at max+1.

    ``grid_thw`` may be one shared grid or a per-example [B, 3] array
    (native dynamic resolution)."""
    b, seq = input_ids.shape
    grids = np.asarray(grid_thw, np.int64)
    if grids.ndim == 1:
        grids = np.broadcast_to(grids, (b, 3))
    out = np.ones((3, b, seq), np.int64)
    for i in range(b):
        t_grid, h_grid, w_grid = (int(grids[i, 0]), int(grids[i, 1]),
                                  int(grids[i, 2]))
        lh = h_grid // spatial_merge_size
        lw = w_grid // spatial_merge_size
        ids = input_ids[i][attention_mask[i] == 1]
        pos_chunks: List[np.ndarray] = []
        st = 0
        tokens = ids.tolist()
        while image_token_id in tokens[st:]:
            ed = tokens.index(image_token_id, st)
            st_idx = pos_chunks[-1].max() + 1 if pos_chunks else 0
            text_len = ed - st
            if text_len:
                pos_chunks.append(
                    np.tile(np.arange(text_len), (3, 1)) + st_idx)
                st_idx = pos_chunks[-1].max() + 1
            t_index = np.zeros(t_grid * lh * lw, np.int64)
            h_index = np.arange(lh)[None, :, None].repeat(t_grid, 0) \
                .repeat(lw, 2).reshape(-1)
            w_index = np.arange(lw)[None, None, :].repeat(t_grid, 0) \
                .repeat(lh, 1).reshape(-1)
            pos_chunks.append(np.stack([t_index, h_index, w_index]) + st_idx)
            st = ed + t_grid * lh * lw
        if st < len(tokens):
            st_idx = pos_chunks[-1].max() + 1 if pos_chunks else 0
            pos_chunks.append(
                np.tile(np.arange(len(tokens) - st), (3, 1)) + st_idx)
        pos = np.concatenate(pos_chunks, axis=1)
        out[:, i, : pos.shape[1]] = pos
    return out


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------

def init_vision_params(cfg: QwenViTConfig, draw: L.ParamDraw) -> Dict:
    h, inter = cfg.hidden_size, cfg.intermediate_size
    merge_h = h * cfg.merge_unit
    params = {
        "patch_embed": draw.dense(cfg.patch_dim, h),
        "merger": {"ln_q": draw.rmsnorm(h),
                   "fc1": draw.dense(merge_h, merge_h, bias=True),
                   "fc2": draw.dense(merge_h, cfg.out_hidden_size,
                                     bias=True)},
        "blocks": [],
    }
    for _ in range(cfg.depth):
        params["blocks"].append({
            "norm1": draw.rmsnorm(h), "norm2": draw.rmsnorm(h),
            "qkv": draw.dense(h, 3 * h, bias=True),
            "proj": draw.dense(h, h, bias=True),
            "gate": draw.dense(h, inter, bias=True),
            "up": draw.dense(h, inter, bias=True),
            "down": draw.dense(inter, h, bias=True),
        })
    return params


def _attend(y, p, cfg: QwenViTConfig, cos, sin, window: Optional[int],
            mask):
    """The block's attention on the normed ``y`` ``[B, S, H]``: fused qkv,
    2-D rotary, then ``attention_chunked`` over ``mask``; with ``window``
    (patches a window) the sequence is cut into ``[B * S / window,
    window]`` tiles first and ``mask`` is theirs."""
    b, s, h = y.shape
    nh, dh = cfg.num_heads, cfg.head_dim
    q, k, v = L.dense(y, p["qkv"]).chunk(3, dim=-1)
    q = L.apply_rope(q.reshape(b, s, nh, dh), cos, sin)
    k = L.apply_rope(k.reshape(b, s, nh, dh), cos, sin)
    v = v.reshape(b, s, nh, dh)
    if window is not None:
        q, k, v = (x.reshape(b * s // window, window, nh, dh)
                   for x in (q, k, v))
    return L.attention_chunked(q, k, v, mask).reshape(b, s, h)


def _mlp(x, p):
    y = L.rmsnorm(x, p["norm2"], eps=1e-6)
    gated = F.silu(L.dense(y, p["gate"])) * L.dense(y, p["up"])
    return x + L.dense(gated, p["down"])


def _merge(x, params, cfg: QwenViTConfig):
    """Spatial merge: ``[B, S, H] -> [B, S / unit, out_hidden]``."""
    b, s, h = x.shape
    y = L.rmsnorm(x, params["merger"]["ln_q"], eps=1e-6)
    y = y.reshape(b, s // cfg.merge_unit, cfg.merge_unit * h)
    y = F.gelu(L.dense(y, params["merger"]["fc1"]), approximate="none")
    return L.dense(y, params["merger"]["fc2"])


def vision_apply(params: Dict, patches: torch.Tensor, cfg: QwenViTConfig,
                 grid_h: int, grid_w: int) -> torch.Tensor:
    """``[B, S, patch_dim]`` host-patchified images of one shared grid ->
    ``[B, U, out_hidden]`` merged features, in the original unit order."""
    lay = vision_layout(grid_h, grid_w, cfg.spatial_merge_size,
                        cfg.window_size, cfg.patch_size, cfg.head_dim,
                        cfg.rope_theta)
    dev = patches.device

    def t(name):
        return torch.from_numpy(lay[name]).to(dev)

    x = L.dense(patches.to(params["patch_embed"]["w"].dtype),
                params["patch_embed"])                     # [B, S, H]
    x = x.index_select(1, t("patch_perm").long())          # window order
    cos, sin = t("cos"), t("sin")
    window_mask = t("window_mask")[None, None]
    full_mask = torch.ones_like(window_mask)
    for i, blk in enumerate(params["blocks"]):
        mask = full_mask if i in cfg.fullatt_block_indexes else window_mask
        y = L.rmsnorm(x, blk["norm1"], eps=1e-6)
        x = x + L.dense(_attend(y, blk, cfg, cos, sin, None, mask),
                        blk["proj"])
        x = _mlp(x, blk)
    return _merge(x, params, cfg).index_select(1, t("unit_inv").long())


# ---------------------------------------------------------------------------
# Native dynamic resolution (variable per-image grids)
#
# Every shape stays static at the FAMILY level, as in the JAX package:
#
#   * each image smart-resizes to its own (grid_h, grid_w) on the host
#     (aspect-preserving, factor 28, [min_pixels, max_pixels]: the HF
#     processor's rules);
#   * the window grid is padded UP so every window holds exactly
#     win_units^2 merge units: windowed attention is a batched attention
#     over [B * n_windows, window_patches] tiles with a small per-window
#     validity mask, never an [S, S] mask (28 of 32 blocks);
#   * every per-image layout table (patch gather order, rotary, validity,
#     inverse unit order) is host-built numpy, padded to the family
#     budget, and uploaded with the batch.
# ---------------------------------------------------------------------------

def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 4 * 28 * 28,
                 max_pixels: int = 768 * 28 * 28) -> Tuple[int, int]:
    """Aspect-preserving resize target with factor-aligned sides and a total
    pixel budget — bit-parity with the HF processor's ``smart_resize``
    (transformers image_processing_qwen2_vl.py; fuzz-tested against it)."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio above 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


@functools.lru_cache(maxsize=256)
def _uniform_window_layout(grid_h: int, grid_w: int, spatial_merge_size: int,
                           window_size: int, patch_size: int, head_dim: int,
                           rope_theta: float, units_pad: int):
    """Per-grid static tables for the uniform-window variable path.

    Unlike ``vision_layout`` (which drops window-padding units), padding
    units are KEPT so every window has exactly ``win_units²`` merge units;
    invalid slots carry ``valid=False`` and gather from a dead zero patch.

    Returns numpy arrays, all padded to ``units_pad`` units (= family
    budget): patch_src [Sp] (index into the image's own patch sequence;
    dead = S), valid [Sp] bool, cos/sin [Sp, hd/2] (window order),
    unit_src [Up] (window-order unit index for original unit u; dead = Up-1).
    """
    m = spatial_merge_size
    lh, lw = grid_h // m, grid_w // m
    win = window_size // m // patch_size
    pad_h, pad_w = (-lh) % win, (-lw) % win
    lhp, lwp = lh + pad_h, lw + pad_w

    index = np.full((lhp, lwp), -1, np.int64)
    index[:lh, :lw] = np.arange(lh * lw).reshape(lh, lw)
    nwh, nww = lhp // win, lwp // win
    units = index.reshape(nwh, win, nww, win).transpose(0, 2, 1, 3)
    unit_perm = units.reshape(-1)                  # [lhp*lwp], -1 = pad unit

    u_real = lhp * lwp
    if u_real > units_pad:
        raise ValueError(
            f"padded window grid {lhp}x{lwp} = {u_real} units exceeds the "
            f"family budget {units_pad}; preprocess_native shrinks such "
            f"images")
    unit_perm_p = np.full(units_pad, -1, np.int64)
    unit_perm_p[:u_real] = unit_perm

    mm = m * m
    sp = units_pad * mm
    # patch gather source, in window order: original patch index (merge-unit-
    # major, the ``patchify`` order), or the dead index S for pad slots
    s_real = grid_h * grid_w
    patch_src = np.full(sp, s_real, np.int64)
    live = unit_perm_p >= 0
    live_units = unit_perm_p[live]
    src = (live_units[:, None] * mm + np.arange(mm)[None]).reshape(-1)
    patch_rows = (np.nonzero(live)[0][:, None] * mm +
                  np.arange(mm)[None]).reshape(-1)
    patch_src[patch_rows] = src
    valid = patch_src < s_real

    # rotary tables over the PADDED window-order sequence (pad slots zero)
    hpos = np.arange(grid_h)[:, None].repeat(grid_w, 1)
    wpos = np.arange(grid_w)[None, :].repeat(grid_h, 0)

    def to_unit_major(pos):
        x = pos.reshape(lh, m, lw, m).transpose(0, 2, 1, 3)
        return x.reshape(-1)

    hpos, wpos = to_unit_major(hpos), to_unit_major(wpos)
    inv = 1.0 / (rope_theta ** (np.arange(0, head_dim // 2, 2, np.float32)
                                / (head_dim // 2)))
    freqs = np.concatenate(
        [hpos[:, None] * inv[None], wpos[:, None] * inv[None]], axis=1)
    freqs_p = np.zeros((sp, freqs.shape[1]), np.float32)
    freqs_p[valid] = freqs[patch_src[valid]]

    # original unit u lives at window-order slot unit_src[u]
    unit_src = np.full(units_pad, units_pad - 1, np.int64)
    slot_of = np.nonzero(live)[0]
    unit_src[live_units] = slot_of

    return {
        "patch_src": patch_src.astype(np.int32),
        "valid": valid,
        "cos": np.cos(freqs_p).astype(np.float32),
        "sin": np.sin(freqs_p).astype(np.float32),
        "unit_src": unit_src.astype(np.int32),
    }


def preprocess_native(image01: np.ndarray, cfg: "QwenVLConfig"
                      ) -> Tuple[Dict, int]:
    """Raw ``[H, W, 3]`` float image in [0, 1] -> (vision item, n merged
    tokens).

    Smart-resize (Pillow's bicubic through ``resize_bicubic``, like the HF
    processor), CLIP-normalize, patchify at the TRUE grid, then pad patches
    and layout tables to the family budget. If the window-padded grid would
    exceed the budget (extreme aspect ratios), the pixel budget is halved
    until it fits: deterministic and still aspect-preserving."""
    v = cfg.vision
    factor = cfg.resize_factor
    units_pad = cfg.padded_window_units
    win = v.window_size // v.patch_size // v.spatial_merge_size

    h, w = image01.shape[:2]
    max_px = cfg.max_pixels
    while True:
        hb, wb = smart_resize(h, w, factor, cfg.min_pixels, max_px)
        lhp = -(-(hb // factor) // win) * win
        lwp = -(-(wb // factor) // win) * win
        if lhp * lwp <= units_pad:
            break
        max_px //= 2

    u8 = np.clip(np.round(image01 * 255.0), 0, 255).astype(np.uint8)
    arr = resize_bicubic(u8, (hb, wb)).astype(np.float32) / 255.0
    mean = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
    arr = (arr - mean) / std

    patches = patchify(arr, v)                       # [S, pd]
    gh, gw = hb // v.patch_size, wb // v.patch_size
    return native_item_from_patches(patches, gh, gw, cfg)


def native_item_from_patches(patches: np.ndarray, gh: int, gw: int,
                             cfg: "QwenVLConfig") -> Tuple[Dict, int]:
    """(vision item, n merged tokens) from already-patchified [S, pd] data
    at grid (gh, gw) — the layout/padding half of ``preprocess_native``."""
    v = cfg.vision
    mm = v.spatial_merge_size ** 2
    units_pad = cfg.padded_window_units
    sp = units_pad * mm
    # + dead zero patch at index S (layout gathers route pads there)
    padded = np.zeros((sp + 1, patches.shape[1]), np.float32)
    padded[:patches.shape[0]] = patches
    lay = _uniform_window_layout(gh, gw, v.spatial_merge_size, v.window_size,
                                 v.patch_size, v.head_dim, v.rope_theta,
                                 units_pad)
    n_units = (gh // v.spatial_merge_size) * (gw // v.spatial_merge_size)
    item = {"patches": padded, "grid_hw": np.array([gh, gw], np.int32),
            **{k: lay[k] for k in
               ("patch_src", "valid", "cos", "sin", "unit_src")}}
    return item, n_units


def batch_native(items) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def vision_apply_native(params: Dict, vision_batch: Dict,
                        cfg: QwenViTConfig) -> torch.Tensor:
    """``[B, Up, out_hidden]`` merged features for per-example grids, each
    example's valid tokens leading in ORIGINAL unit order. ``vision_batch``
    is ``batch_native``'s dict as tensors on the device.

    Windowed blocks run as batched attention over uniform
    ``[B * n_windows, window_patches]`` tiles; the full-attention blocks
    use a validity mask over the padded sequence. Pad slots attend to
    themselves (the ``eye`` term), so no softmax row is empty."""
    patches = vision_batch["patches"]          # [B, Sp+1, pd]
    patch_src = vision_batch["patch_src"]      # [B, Sp]
    valid = vision_batch["valid"].bool()       # [B, Sp]
    cos = vision_batch["cos"]                  # [B, Sp, hd/2]
    sin = vision_batch["sin"]
    unit_src = vision_batch["unit_src"]        # [B, Up]

    b, sp = patch_src.shape
    wp = (cfg.window_size // cfg.patch_size) ** 2   # patches per window
    nw = sp // wp
    h = cfg.hidden_size
    dev = patches.device

    x = L.dense(patches.to(params["patch_embed"]["w"].dtype),
                params["patch_embed"])               # [B, Sp+1, H]
    x = torch.gather(x, 1, patch_src.long()[:, :, None].expand(-1, -1, h))

    vwin = valid.reshape(b * nw, wp)
    win_mask = (vwin[:, None, :, None] & vwin[:, None, None, :]) | \
        torch.eye(wp, dtype=torch.bool, device=dev)[None, None]
    full_mask = (valid[:, None, :, None] & valid[:, None, None, :]) | \
        torch.eye(sp, dtype=torch.bool, device=dev)[None, None]

    for i, blk in enumerate(params["blocks"]):
        y = L.rmsnorm(x, blk["norm1"], eps=1e-6)
        if i in cfg.fullatt_block_indexes:
            attn = _attend(y, blk, cfg, cos, sin, None, full_mask)
        else:
            attn = _attend(y, blk, cfg, cos, sin, wp, win_mask)
        x = _mlp(x + L.dense(attn, blk["proj"]), blk)

    y = _merge(x, params, cfg)                        # [B, Up, out]
    return torch.gather(
        y, 1, unit_src.long()[:, :, None].expand(-1, -1, y.shape[-1]))


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_params(cfg: QwenVLConfig, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> Dict:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live there), with the JAX package's scaling (the draws differ)."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, weights on "
                         f"{device}")
    return {
        "vision": init_vision_params(cfg.vision,
                                     L.ParamDraw(generator, device, dtype)),
        "text": llama.init_params(cfg.text, generator, device, dtype),
    }


def encode(params: Dict, cfg: QwenVLConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor, patches=None,
           position_ids: Optional[torch.Tensor] = None,
           reps_loc: RepsLoc = RepsLoc.BEFORE_PAD,
           lora: Optional[Dict] = None, remat: bool = False,
           allow_flash: bool = True, lora_seed: Optional[int] = None,
           lora_dropout: float = 0.0, lora_rows=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sparse_weights [B, V] f32, dense_embs [B, H])``. ``patches``:
    ``[B, S, patch_dim]`` (fixed grid) or ``batch_native``'s dict as
    tensors (native resolution). ``position_ids``: the ``[3, B, T]`` M-RoPE
    ids of image inputs; text-only inputs take 1-D positions (M-RoPE
    degenerates to them). The ``vision``, ``tower`` and ``lm_head`` ranges
    name the stages in a profiler trace."""
    lget = (lambda name: lora.get(name) if lora else None)
    embeds = llama.embed_tokens(params["text"], input_ids)
    if patches is not None:
        with span("vision"):
            if isinstance(patches, dict):
                feats = vision_apply_native(params["vision"], patches,
                                            cfg.vision)
            else:
                feats = vision_apply(params["vision"], patches, cfg.vision,
                                     cfg.grid_h, cfg.grid_w)
            embeds = splice_image_embeddings(
                embeds, feats.to(embeds.dtype),
                input_ids == cfg.image_token_id)
    with span("tower"):
        hidden = llama.apply(params["text"], embeds, attention_mask,
                             cfg.text, lget("text"),
                             position_ids=position_ids, remat=remat,
                             allow_flash=allow_flash, lora_seed=lora_seed,
                             lora_dropout=lora_dropout, lora_rows=lora_rows)
    with span("lm_head"):
        head = llama.lm_head_weight(params["text"], cfg.text)
        return R.extract_reps(hidden, attention_mask, head, reps_loc)
