"""Image rules of the reference: what the port derives from an image
before its vision tower runs, written from the published processors.

- ``resize_bicubic``: Pillow's BICUBIC on uint8 (a frozen copy of the
  port's ``models/anyres.resize_bicubic``, which is held bit-equal to
  Pillow; the card's machine has no Pillow);
- Qwen2.5-VL: Hugging Face's ``Qwen2VLImageProcessor`` (``smart_resize``
  to multiples of 28 within the pixel budget, the CLIP mean and std, the
  patch layout ``(t, h/m, w/m, m, m) x (c, t, p, p)`` with the frame
  repeated over the temporal patch), under the port's pipeline budget
  (``max_pixels`` and its window-padded grid, halved until it fits);
- InternVL2.5: ``dynamic_preprocess`` of the InternVL chat model (the
  closest aspect-ratio grid of 1-12 tiles, ties to the larger grid when the
  image covers half of it, a 448 px thumbnail after two or more tiles,
  ImageNet mean and std).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

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


def resize_bicubic(img_u8: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Pillow's ``Image.resize((w, h), BICUBIC)`` on a uint8 ``[H, W, 3]``
    image: the horizontal pass first, then the vertical, each skipped when
    its size does not change."""
    h, w = size_hw
    out = np.asarray(img_u8, np.uint8)
    if w != out.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != out.shape[0]:
        out = _resample_axis(out, h, 0)
    return np.ascontiguousarray(out)


CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


# ---- Qwen2.5-VL ------------------------------------------------------------------

def smart_resize(height: int, width: int, factor: int, min_pixels: int,
                 max_pixels: int) -> Tuple[int, int]:
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


def qwen_patches(image01: np.ndarray, patch: int, merge: int,
                 temporal: int, window: int, min_pixels: int,
                 max_pixels: int) -> Tuple[np.ndarray, int, int]:
    """(flattened patches ``[gh * gw, 3 * temporal * patch^2]``, gh, gw) of
    a ``[H, W, 3]`` image in [0, 1]."""
    factor = patch * merge
    win = window // patch // merge
    budget = -(-int(max_pixels // factor ** 2 * 1.5) // (win * win)) \
        * win * win
    h, w = image01.shape[:2]
    while True:
        hb, wb = smart_resize(h, w, factor, min_pixels, max_pixels)
        if (-(-(hb // factor) // win) * win) * (-(-(wb // factor) // win)
                                                * win) <= budget:
            break
        max_pixels //= 2
    u8 = np.clip(np.round(image01 * 255.0), 0, 255).astype(np.uint8)
    arr = resize_bicubic(u8, (hb, wb)).astype(np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    frames = np.repeat(arr.transpose(2, 0, 1)[None], temporal, axis=0)
    gh, gw = hb // patch, wb // patch
    x = frames.reshape(1, temporal, 3, gh // merge, merge, patch,
                       gw // merge, merge, patch)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return (np.ascontiguousarray(x.reshape(gh * gw, -1), np.float32),
            gh, gw)


# ---- InternVL2.5 -------------------------------------------------------------------

def _target_ratios(min_num: int, max_num: int) -> List[Tuple[int, int]]:
    ratios = {(i, j) for n in range(min_num, max_num + 1)
              for i in range(1, n + 1) for j in range(1, n + 1)
              if min_num <= i * j <= max_num}
    return sorted(ratios, key=lambda r: r[0] * r[1])


def _closest_ratio(aspect, ratios, width, height, size):
    best_diff, best = float("inf"), (1, 1)
    area = width * height
    for r in ratios:
        diff = abs(aspect - r[0] / r[1])
        if diff < best_diff:
            best_diff, best = diff, r
        elif diff == best_diff and area > 0.5 * size * size * r[0] * r[1]:
            best = r
    return best


def internvl_tiles(image01: np.ndarray, size: int, max_num: int,
                   thumbnail: bool) -> np.ndarray:
    """``[n, size, size, 3]`` normalised tiles of a ``[H, W, 3]`` image in
    [0, 1] (made uint8 by truncation, as the port's pipeline does)."""
    arr = (np.clip(np.asarray(image01), 0, 1) * 255).astype(np.uint8)
    h, w = arr.shape[:2]
    cols, rows = _closest_ratio(w / h, _target_ratios(1, max_num), w, h,
                                size)
    big = resize_bicubic(arr, (size * rows, size * cols))
    tiles = [big[r * size:(r + 1) * size, c * size:(c + 1) * size]
             for r in range(rows) for c in range(cols)]
    if thumbnail and len(tiles) != 1:
        tiles.append(resize_bicubic(arr, (size, size)))
    return np.stack([(t.astype(np.float32) / 255.0 - IMAGENET_MEAN)
                     / IMAGENET_STD for t in tiles])
