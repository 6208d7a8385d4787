"""InternVL-style dynamic image tiling on the host (a copy of the JAX
package's ``data/tiling.py``, pure numpy).

An input image is split into up to ``max_num`` square tiles along the
closest-aspect-ratio grid, plus a thumbnail tile when more than one tile is
used; tiles are ImageNet-normalized. The variable tile count becomes a
static shape by padding to ``max_num + 1`` tiles (``pad_tiles``).

Resizing is Pillow's BICUBIC through ``models.anyres.resize_bicubic``, equal
to Pillow bit for bit on uint8, so the port needs no Pillow and gives the
JAX package's tiles byte for byte. For a batch headed for a CUDA device the
pipelines make the same tiles on the card (``ops/tile_kernel.py``) from the
uint8 images and grids of ``to_uint8`` and ``tile_grid``; this numpy tiling
is the CPU path and the kernel's reference.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mllm_sparse_retrieval_tpu_torch.models.anyres import resize_bicubic

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def candidate_grids(min_num: int, max_num: int) -> List[Tuple[int, int]]:
    """All (cols, rows) grids with min_num <= cols*rows <= max_num."""
    out = set()
    for n in range(min_num, max_num + 1):
        for cols in range(1, n + 1):
            if n % cols == 0:
                out.add((cols, n // cols))
    return sorted(out, key=lambda g: g[0] * g[1])


def closest_aspect_ratio(
    aspect: float, grids: List[Tuple[int, int]], width: int, height: int,
    tile_size: int,
) -> Tuple[int, int]:
    """Pick the grid whose aspect ratio is closest; ties prefer the larger
    area when the image is big enough."""
    best = (1, 1)
    best_diff = float("inf")
    area = width * height
    for cols, rows in grids:
        target = cols / rows
        diff = abs(aspect - target)
        if diff < best_diff:
            best_diff = diff
            best = (cols, rows)
        elif diff == best_diff:
            if area > 0.5 * tile_size * tile_size * cols * rows:
                best = (cols, rows)
    return best


def to_uint8(image: np.ndarray) -> np.ndarray:
    """A ``[H, W, 3]`` image in [0, 1] as uint8, as the JAX package makes
    it: ``clip * 255``, truncated."""
    return (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)


def tile_grid(height: int, width: int, tile_size: int = 448,
              min_num: int = 1, max_num: int = 12) -> Tuple[int, int]:
    """The (cols, rows) grid ``dynamic_tile`` cuts an image of this size
    into."""
    return closest_aspect_ratio(width / height,
                                candidate_grids(min_num, max_num),
                                width, height, tile_size)


def tile_uint8(arr: np.ndarray, grid: Tuple[int, int], tile_size: int = 448,
               use_thumbnail: bool = True) -> np.ndarray:
    """``dynamic_tile`` of a uint8 image on a given (cols, rows) grid."""
    cols, rows = grid
    resized = resize_bicubic(arr, (tile_size * rows, tile_size * cols))
    tiles = [resized[r * tile_size:(r + 1) * tile_size,
                     c * tile_size:(c + 1) * tile_size]
             for r in range(rows) for c in range(cols)]
    if use_thumbnail and len(tiles) > 1:
        tiles.append(resize_bicubic(arr, (tile_size, tile_size)))

    return np.stack([
        (t.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        for t in tiles])


def dynamic_tile(
    image: np.ndarray,           # [H, W, 3] float array in [0, 1]
    tile_size: int = 448,
    min_num: int = 1,
    max_num: int = 12,
    use_thumbnail: bool = True,
) -> np.ndarray:
    """Split into aspect-ratio-matched tiles. Returns ``[n_tiles, S, S, 3]``
    ImageNet-normalized float32 (``n_tiles <= max_num + 1``). The image is
    made uint8 as the JAX package makes it (``to_uint8``)."""
    arr = to_uint8(image)
    h, w = arr.shape[:2]
    return tile_uint8(arr, tile_grid(h, w, tile_size, min_num, max_num),
                      tile_size, use_thumbnail)


def pad_tiles(
    tiles: np.ndarray, max_tiles: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ``[n, S, S, 3]`` to ``[max_tiles, S, S, 3]`` + a bool validity
    mask: the static-shape batch form."""
    n = tiles.shape[0]
    if n > max_tiles:
        tiles = tiles[:max_tiles]
        n = max_tiles
    padded = np.zeros((max_tiles,) + tiles.shape[1:], tiles.dtype)
    padded[:n] = tiles
    mask = np.zeros(max_tiles, bool)
    mask[:n] = True
    return padded, mask
