"""LLaVA-NeXT "anyres" multi-patch image preprocessing, on the host (a copy
of the JAX package's ``models/anyres.py``, pure numpy).

Pick the best grid resolution from ``image_grid_pinpoints``, resize and pad
the image onto that canvas, split it into square tiles, prepend the
tile-resized whole image, and build the gather map that lays the tile
features out as HF's ``pack_image_features`` does (unpadded feature rows,
each ending in the ``image_newline`` embedding). The device sees static
shapes only: ``pixels [max_tiles, S, S, 3]`` and ``feature_index
[max_image_tokens]``.

Resizing is HF's PIL BICUBIC, re-implemented in numpy (``resize_bicubic``)
so the port needs no Pillow: the same two separable passes, coefficients and
fixed-point rounding as Pillow's ``Resample.c``, bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

# llava-hf/llama3-llava-next-8b-hf / llava-v1.6 default pinpoints.
DEFAULT_GRID_PINPOINTS: Tuple[Tuple[int, int], ...] = (
    (336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008))

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_PRECISION_BITS = 32 - 8 - 2    # Pillow's 8-bit fixed point
_BICUBIC_SUPPORT = 2.0
_BLOCK = 64                     # output pixels per resample matrix product


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel, a = -0.5, in Pillow's order of operations."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: per output
    pixel the first input index and ``ksize`` int32 weights (22-bit fixed
    point, zero past the window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C truncates toward zero; clamping at 0 makes that a floor here
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    x = np.arange(ksize)[None, :]
    live = x < xmax[:, None]
    w = _bicubic_filter(((x + xmin[:, None]) - center[:, None] + 0.5)
                        * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]      # sequential sum, as the C loop
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + fixed, 0.5 + fixed)).astype(np.int64)
    return xmin, k


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass over ``axis`` (0 rows, 1 columns) of a uint8
    ``[H, W, C]`` image: integer weighted sums, round, ``>> 22``, clip to
    uint8. The sums run as float64 matrix products over blocks of
    ``_BLOCK`` output pixels: every product and partial sum is an integer
    below 2^31, so float64 holds each exactly and the order of the additions
    cannot change the result."""
    in_size = img.shape[axis]
    xmin, k = _coefficients(in_size, out_size)
    ksize = k.shape[1]
    src = np.moveaxis(img, axis, 0)
    rest = src.shape[1:]
    src = src.reshape(in_size, -1).astype(np.float64)
    acc = np.empty((out_size, src.shape[1]), np.float64)
    for o0 in range(0, out_size, _BLOCK):
        o1 = min(out_size, o0 + _BLOCK)
        lo = int(xmin[o0])                 # xmin never decreases
        hi = min(in_size, int(xmin[o1 - 1]) + ksize)
        cols = xmin[o0:o1, None] - lo + np.arange(ksize)[None, :]
        rows = np.broadcast_to(np.arange(o1 - o0)[:, None], cols.shape)
        live = cols < hi - lo               # weights past the image are 0
        w = np.zeros((o1 - o0, hi - lo))
        w[rows[live], cols[live]] = k[o0:o1][live]
        acc[o0:o1] = w @ src[lo:hi]
    shifted = np.floor((acc + (1 << (_PRECISION_BITS - 1)))
                       / (1 << _PRECISION_BITS))
    out = np.clip(shifted, 0, 255).astype(np.uint8).reshape(
        (out_size,) + rest)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img_u8: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((w, h), Image.BICUBIC)`` on a uint8
    ``[H, W, 3]`` image, equal to Pillow bit for bit: the horizontal pass
    first, then the vertical, each skipped when its size does not change."""
    h, w = size_hw
    out = np.asarray(img_u8, np.uint8)
    if w != out.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != out.shape[0]:
        out = _resample_axis(out, h, 0)
    return np.ascontiguousarray(out)


def select_best_resolution(
    original_size: Tuple[int, int],
    pinpoints: Sequence[Tuple[int, int]],
) -> Tuple[int, int]:
    """HF ``select_best_resolution``: maximize effective resolution, then
    minimize wasted canvas. Sizes are (height, width)."""
    oh, ow = original_size
    best = None
    max_eff = 0
    min_waste = float("inf")
    for h, w in pinpoints:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best = eff, waste, (h, w)
    return best


def grid_shape(original_size: Tuple[int, int],
               pinpoints: Sequence[Tuple[int, int]],
               tile_size: int) -> Tuple[int, int]:
    """(num_patch_height, num_patch_width) for the chosen canvas."""
    h, w = select_best_resolution(original_size, pinpoints)
    return h // tile_size, w // tile_size


def _patch_output_size(original_size, target_resolution) -> Tuple[int, int]:
    """HF ``_get_patch_output_size``: aspect-preserving fit into the canvas."""
    oh, ow = original_size
    th, tw = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw = tw
        nh = min(math.ceil(oh * scale_w), th)
    else:
        nh = th
        nw = min(math.ceil(ow * scale_h), tw)
    return nh, nw


def unpad_dims(original_size: Tuple[int, int],
               current: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """HF ``unpad_image`` arithmetic on the FEATURE grid.

    ``current`` = (nph·pps, npw·pps). Returns (h', w', pad_top, pad_left):
    the cropped grid dims and the crop offsets. HF crops ``[pad : cur -
    pad]``, so the result is ``cur - 2·pad`` (one off the rounded new size
    when parities differ), reproduced exactly.
    """
    oh, ow = original_size
    ch, cw = current
    if ow / oh > cw / ch:
        scale = cw / ow
        new_h = int(round(oh * scale, 7))
        pad = (ch - new_h) // 2
        return ch - 2 * pad, cw, pad, 0
    scale = ch / oh
    new_w = int(round(ow * scale, 7))
    pad = (cw - new_w) // 2
    return ch, cw - 2 * pad, 0, pad


def num_image_tokens(original_size: Tuple[int, int],
                     pinpoints: Sequence[Tuple[int, int]],
                     tile_size: int, pps: int) -> int:
    """Final spliced embedding count: base ppt + h'·(w'+1) (newlines);
    ``pps`` = patches per tile side, ppt = pps²."""
    nph, npw = grid_shape(original_size, pinpoints, tile_size)
    h, w, _, _ = unpad_dims(original_size, (nph * pps, npw * pps))
    return pps * pps + h * (w + 1)


def max_image_tokens(pinpoints: Sequence[Tuple[int, int]],
                     tile_size: int, pps: int) -> int:
    """Static upper bound over all pinpoints (no-crop worst case)."""
    best = pps * pps + 1
    for h, w in pinpoints:
        nph, npw = h // tile_size, w // tile_size
        best = max(best, pps * pps + (nph * pps) * (npw * pps + 1))
    return best


def max_tiles(pinpoints: Sequence[Tuple[int, int]], tile_size: int) -> int:
    """Static tile-count bound: base + largest grid."""
    return 1 + max((h // tile_size) * (w // tile_size) for h, w in pinpoints)


def feature_index(
    original_size: Tuple[int, int],
    pinpoints: Sequence[Tuple[int, int]],
    tile_size: int,
    pps: int,
    n_tiles_max: int,
    n_tokens_max: int,
) -> Tuple[np.ndarray, int]:
    """Gather map [n_tokens_max] into the flattened feature table.

    Table layout: tile t occupies rows ``t·ppt .. (t+1)·ppt - 1`` (tile 0 =
    base image, tiles 1.. = grid patches row-major); row ``n_tiles_max·ppt``
    is the ``image_newline`` embedding. Padding positions point at the
    newline row (in bounds; never spliced). Returns (index, n_tokens).
    """
    ppt = pps * pps
    newline = n_tiles_max * ppt
    idx = np.full(n_tokens_max, newline, np.int32)
    idx[:ppt] = np.arange(ppt, dtype=np.int32)     # base image features first
    pos = ppt
    nph, npw = grid_shape(original_size, pinpoints, tile_size)
    h, w, pad_t, pad_l = unpad_dims(original_size, (nph * pps, npw * pps))
    rows = np.arange(h, dtype=np.int64)[:, None] + pad_t       # [h, 1]
    cols = np.arange(w, dtype=np.int64)[None, :] + pad_l       # [1, w]
    tile = 1 + (rows // pps) * npw + (cols // pps)             # [h, w]
    within = (rows % pps) * pps + (cols % pps)                 # [h, w]
    grid_idx = tile * ppt + within                             # [h, w]
    with_nl = np.concatenate(
        [grid_idx, np.full((h, 1), newline, np.int64)], axis=1)  # [h, w+1]
    flat = with_nl.reshape(-1)
    idx[pos:pos + flat.size] = flat.astype(np.int32)
    return idx, pos + flat.size


@dataclass
class AnyresImage:
    """Host-preprocessed image, static device shapes."""
    pixels: np.ndarray         # [n_tiles_max, S, S, 3] float32, normalized
    feature_index: np.ndarray  # [n_tokens_max] int32
    n_tokens: int              # actual spliced embedding count
    n_tiles: int               # actual tile count (incl. base)


def preprocess_anyres(
    image: np.ndarray,            # [H, W, 3] float in [0,1] or uint8
    pinpoints: Sequence[Tuple[int, int]],
    tile_size: int,
    pps: int,
    n_tiles_max: int,
    n_tokens_max: int,
    mean: np.ndarray = CLIP_MEAN,
    std: np.ndarray = CLIP_STD,
) -> AnyresImage:
    """Full anyres host path: HF ``get_image_patches`` + the feature map.

    Tile order matches HF: [base-resized original] + canvas patches
    (row-major). Invalid (padding) tiles are zeros; their ViT outputs are
    computed but never gathered.
    """
    if image.dtype != np.uint8:
        img_u8 = (np.clip(image, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    else:
        img_u8 = image
    oh, ow = img_u8.shape[:2]
    best = select_best_resolution((oh, ow), pinpoints)
    nh, nw = _patch_output_size((oh, ow), best)
    resized = resize_bicubic(img_u8, (nh, nw))
    canvas = np.zeros((best[0], best[1], 3), np.uint8)
    top, left = (best[0] - nh) // 2, (best[1] - nw) // 2
    canvas[top:top + nh, left:left + nw] = resized

    tiles: List[np.ndarray] = [resize_bicubic(img_u8, (tile_size, tile_size))]
    for r in range(0, best[0], tile_size):
        for c in range(0, best[1], tile_size):
            tiles.append(canvas[r:r + tile_size, c:c + tile_size])
    n_tiles = len(tiles)

    pixels = np.zeros((n_tiles_max, tile_size, tile_size, 3), np.float32)
    for i, t in enumerate(tiles[:n_tiles_max]):
        pixels[i] = (t.astype(np.float32) / 255.0 - mean) / std

    idx, n_tokens = feature_index((oh, ow), pinpoints, tile_size, pps,
                                  n_tiles_max, n_tokens_max)
    return AnyresImage(pixels=pixels, feature_index=idx,
                       n_tokens=n_tokens, n_tiles=min(n_tiles, n_tiles_max))
