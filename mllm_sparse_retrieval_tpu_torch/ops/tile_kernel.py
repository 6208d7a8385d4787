"""InternVL's dynamic tiling on the card: the hand-written CUDA kernel, its
plain PyTorch version, and the host plan both take.

``stage(images, tile_size, max_num)`` does the host's share for a batch of
raw ``[H, W, 3]`` images in [0, 1]: each image made uint8 and its tile grid
chosen (``data/tiling.py``'s ``to_uint8`` and ``tile_grid``), which fixes
its tile count and so its prompt. The ``StagedTiles`` it returns makes the
padded, ImageNet-normalised ``[B, max_num + 1, S, S, 3]`` f32 tiles where
they are used (``StagedTiles.to(device)``): on a CUDA device the images and
the resample tables go up in one copy from pinned memory and the kernel
(``csrc/tile.cu``; its design notes are in the source) tiles them, two
launches on the current stream with no host sync, inside a ``tile`` span;
on any other device ``data/tiling.py``'s numpy tiling makes them. Both give
the same bytes. Rows slice (``staged[lo:hi]``) before they are made.

``tile_images`` takes the plain version only for a buffer on the CPU. For a
CUDA buffer it launches the kernel or raises; there is no fallback. Every
launch adds one to the module's launch count (one a staged batch: its two
kernels), which a run reads to show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.data.tiling import (
    IMAGENET_MEAN, IMAGENET_STD, pad_tiles, tile_grid, tile_uint8, to_uint8)
from mllm_sparse_retrieval_tpu_torch.models.anyres import _coefficients
from mllm_sparse_retrieval_tpu_torch.ops import cuda_build
from mllm_sparse_retrieval_tpu_torch.tracing import span

SOURCE = "tile.cu"
THREADS = 256       # threads a block, both kernels (csrc/tile.cu)
JOB = 8             # int32 fields of a job in the tables
NORM = 8            # int32 fields before the first job: mean, std, unused

_count_lock = threading.Lock()
_launches = 0
_lib = None


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count`` (one a staged
    batch)."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        lib.tile_images.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_void_p]
        lib.tile_images.restype = ctypes.c_int
        lib.tile_error_string.argtypes = [ctypes.c_int]
        lib.tile_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=256)
def _table(n_in: int, n_out: int) -> np.ndarray:
    """Pillow's resample table of ``n_in`` -> ``n_out`` pixels: a row per
    output pixel, ``[first input, weights...]`` int32. Where the size does
    not change its weights are exactly 0 but one 1.0 (Pillow's bicubic is
    0 at every nonzero integer offset), the pass Pillow skips."""
    xmin, k = _coefficients(n_in, n_out)
    return np.concatenate([xmin[:, None], k], 1).astype(np.int32)


@dataclass
class Launch:
    """The kernel's arguments besides its buffer."""
    n_h: int            # horizontal jobs
    h_blocks: int       # their blocks
    batch: int
    slots: int          # tiles an image, padding included
    tile: int           # tile side


@dataclass
class Layout:
    """A staged batch's buffer: the int32 tables, then the raw images at
    ``offsets``, then the scratch of the horizontal passes."""
    tables: np.ndarray
    offsets: List[int]
    upload_bytes: int   # tables and images
    total_bytes: int    # and the scratch
    launch: Launch

    def write(self, buf: np.ndarray, images: Sequence[np.ndarray]) -> None:
        """Fill ``buf`` (uint8, at least ``upload_bytes``) with the tables
        and the images."""
        raw = self.tables.view(np.uint8)
        buf[:raw.size] = raw
        for img, off in zip(images, self.offsets):
            buf[off:off + img.size] = img.reshape(-1)


def _align(n: int) -> int:
    return -(-n // 16) * 16


def plan(shapes: Sequence[Tuple[int, int]], grids: Sequence[Tuple[int, int]],
         tile: int, slots: int) -> Layout:
    """The tables and byte layout of a batch of images of ``shapes`` (H, W)
    cut into ``grids`` (cols, rows) of ``tile``-pixel tiles, ``slots`` a
    image (``csrc/tile.cu`` gives the format)."""
    keys: dict = {}                 # (n_in, n_out) -> index into tables

    def table(n_in, n_out):
        return keys.setdefault((n_in, n_out), len(keys))

    hjobs, vjobs, scratch = [], [], 0
    for b, ((h, w), (cols, rows)) in enumerate(zip(shapes, grids)):
        targets = [(rows * tile, cols * tile)]
        if cols * rows > 1:
            targets.append((tile, tile))            # the thumbnail
        sources = []
        for out_h, out_w in targets:
            if out_w == w:               # an unchanged width: no pass
                sources.append((("raw", b), w, table(h, out_h)))
                continue
            hjobs.append([("raw", b), w, out_w, h, table(w, out_w),
                          ("scratch", scratch)])
            sources.append((("scratch", scratch), out_w, table(h, out_h)))
            scratch += h * out_w * 3
        for t in range(slots):
            if t < cols * rows:
                src, src_w, tab = sources[0]
                vjobs.append((src, src_w, (t % cols) * tile,
                              (t // cols) * tile, tab, h, 1))
            elif t == cols * rows and len(sources) > 1:
                src, src_w, tab = sources[1]
                vjobs.append((src, src_w, 0, 0, tab, h, 1))
            else:
                vjobs.append(None)

    tables = [_table(*k) for k in keys]
    at = NORM + JOB * (len(hjobs) + len(vjobs))
    table_at = []
    for t in tables:
        table_at.append(at)
        at += t.size
    offsets, raw_end = [], _align(4 * at)
    for h, w in shapes:
        offsets.append(raw_end)
        raw_end += h * w * 3
    scratch_at = _align(raw_end)
    if scratch_at + scratch >= 1 << 31:
        raise ValueError(f"a staged batch of {scratch_at + scratch} bytes "
                         f"exceeds the kernel's 32-bit offsets")

    def byte_offset(src):
        kind, i = src
        return offsets[i] if kind == "raw" else scratch_at + i

    out = np.zeros(at, np.int32)
    out[:6] = np.concatenate([IMAGENET_MEAN, IMAGENET_STD]).view(np.int32)
    row, block = NORM, 0
    for src, in_w, out_w, h, tab, dst in hjobs:
        out[row:row + JOB] = (byte_offset(src), in_w, out_w, h, table_at[tab],
                              tables[tab].shape[1] - 1, byte_offset(dst),
                              block)
        block += -(-h * out_w // THREADS)
        row += JOB
    for job in vjobs:
        if job is not None:
            src, src_w, x0, y0, tab, h, live = job
            out[row:row + JOB] = (byte_offset(src), src_w, x0, y0,
                                  table_at[tab], tables[tab].shape[1] - 1, h,
                                  live)
        row += JOB
    for t, a in zip(tables, table_at):
        out[a:a + t.size] = t.reshape(-1)
    return Layout(out, offsets, raw_end,
                  _align(scratch_at + scratch),
                  Launch(len(hjobs), block, len(shapes), slots, tile))


def _resample(img: torch.Tensor, table: torch.Tensor, axis: int
              ) -> torch.Tensor:
    """One pass of Pillow's resample over ``axis`` (0 rows, 1 columns) of
    an int32 ``[H, W, 3]`` image by a ``plan`` table: the int32 sums from
    ``1 << 21``, shifted right by 22, clipped to uint8. Weights past the
    image's edge are 0, so their clamped reads add nothing."""
    n_in = img.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = table.shape[0]
    acc = torch.full(img.shape[:axis] + (table.shape[0],)
                     + img.shape[axis + 1:], 1 << 21, dtype=torch.int32,
                     device=img.device)
    for i in range(table.shape[1] - 1):
        idx = (table[:, 0] + i).clamp(max=n_in - 1).long()
        acc += table[:, 1 + i].view(shape) * img.index_select(axis, idx)
    return (acc >> 22).clamp(0, 255).to(torch.uint8)


def tile_images_plain(data: torch.Tensor, launch: Launch) -> torch.Tensor:
    """Plain PyTorch version: the kernel's two passes, job by job, in the
    same integer and f32 arithmetic (on any device; the wrapper takes it
    for CPU buffers)."""
    buf = data.clone()
    tab = data.view(torch.int32)
    norm = tab[:6].view(torch.float32)
    jobs = tab[NORM:NORM + JOB * (launch.n_h + launch.batch * launch.slots)]
    jobs = jobs.view(-1, JOB).tolist()
    for src, in_w, out_w, rows, coef, ksize, dst, _ in jobs[:launch.n_h]:
        img = buf[src:src + rows * in_w * 3].view(rows, in_w, 3).int()
        table = tab[coef:coef + out_w * (ksize + 1)].view(out_w, ksize + 1)
        buf[dst:dst + rows * out_w * 3] = _resample(img, table, 1).view(-1)
    s = launch.tile
    out = torch.zeros((launch.batch * launch.slots, s, s, 3),
                      dtype=torch.float32, device=data.device)
    for slot, (src, src_w, x0, y0, coef, ksize, in_h, live) in enumerate(
            jobs[launch.n_h:]):
        if not live:
            continue
        img = buf[src:src + in_h * src_w * 3].view(in_h, src_w, 3)
        table = tab[coef + y0 * (ksize + 1):coef + (y0 + s) * (ksize + 1)]
        u = _resample(img[:, x0:x0 + s].int(), table.view(s, ksize + 1), 0)
        out[slot] = (u.float() / 255.0 - norm[:3]) / norm[3:]
    return out.view(launch.batch, launch.slots, s, s, 3)


def tile_images(data: torch.Tensor, launch: Launch) -> torch.Tensor:
    """``[batch, slots, tile, tile, 3]`` f32 tiles of a staged buffer
    (``StagedTiles.packed``): uint8, 1-D, contiguous, holding its tables and
    images and room for the scratch."""
    if data.dtype != torch.uint8 or data.dim() != 1 or \
            not data.is_contiguous() or data.numel() % 16:
        raise ValueError(f"need a contiguous 1-D uint8 buffer of whole "
                         f"16-byte words, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if data.device.type == "cpu":
        return tile_images_plain(data, launch)
    if data.device.type != "cuda":
        raise ValueError(f"no tile kernel for device {data.device}")
    if data.data_ptr() % 16:
        raise ValueError("buffer storage must be 16-byte aligned")
    s = launch.tile
    out = torch.empty((launch.batch, launch.slots, s, s, 3),
                      dtype=torch.float32, device=data.device)
    lib = _library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.tile_images(data.data_ptr(), launch.n_h, launch.h_blocks,
                             launch.batch, launch.slots, s, out.data_ptr(),
                             stream)
    if rc != 0:
        msg = lib.tile_error_string(rc).decode()
        raise RuntimeError(f"tile kernel launch failed ({rc}): {msg}")
    global _launches
    with _count_lock:
        _launches += 1
    return out


class StagedTiles:
    """A batch's dynamic tiles, planned on the host: uint8 images and their
    (cols, rows) grids. ``shape`` is the tiles' ``[B, max_num + 1, S, S,
    3]``; ``np.asarray`` makes them with the numpy tiling."""

    def __init__(self, images: List[np.ndarray],
                 grids: List[Tuple[int, int]], tile_size: int, max_num: int):
        self.images = images
        self.grids = grids
        self.tile_size = tile_size
        self.max_num = max_num

    @property
    def n_tiles(self) -> List[int]:
        """Each image's tiles: its grid, and a thumbnail beside more than
        one."""
        return [c * r + (c * r > 1) for c, r in self.grids]

    @property
    def shape(self) -> Tuple[int, ...]:
        s = self.tile_size
        return (len(self.images), self.max_num + 1, s, s, 3)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, rows: slice) -> "StagedTiles":
        if not isinstance(rows, slice):
            raise TypeError(f"StagedTiles take a slice of rows, got "
                            f"{type(rows).__name__}")
        return StagedTiles(self.images[rows], self.grids[rows],
                           self.tile_size, self.max_num)

    def numpy(self) -> np.ndarray:
        """The tiles as ``data/tiling.py`` makes them (``dynamic_tile`` +
        ``pad_tiles``, stacked)."""
        s, slots = self.tile_size, self.max_num + 1
        return np.stack([pad_tiles(tile_uint8(a, g, s), slots)[0]
                         for a, g in zip(self.images, self.grids)])

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)

    def packed(self, device) -> Tuple[torch.Tensor, Launch]:
        """The staged buffer on ``device`` and the launch's arguments; on a
        CUDA device uploaded from pinned memory with ``non_blocking``."""
        device = torch.device(device)
        layout = plan([a.shape[:2] for a in self.images], self.grids,
                      self.tile_size, self.max_num + 1)
        if device.type != "cuda":
            data = torch.empty(layout.total_bytes, dtype=torch.uint8)
            layout.write(data.numpy(), self.images)
            return data.to(device), layout.launch
        host = torch.empty(layout.upload_bytes, dtype=torch.uint8,
                           pin_memory=True)
        layout.write(host.numpy(), self.images)
        data = torch.empty(layout.total_bytes, dtype=torch.uint8,
                           device=device)
        data[:layout.upload_bytes].copy_(host, non_blocking=True)
        return data, layout.launch

    def to(self, device) -> torch.Tensor:
        """The tiles on ``device``: made by the kernel on a CUDA device (a
        ``tile`` span, attrs ``images`` and ``tiles``), by the numpy tiling
        elsewhere."""
        device = torch.device(device)
        if device.type != "cuda":
            return torch.from_numpy(self.numpy()).to(device)
        with span("tile", images=len(self), tiles=sum(self.n_tiles)):
            return tile_images(*self.packed(device))


def stage(images: Sequence[np.ndarray], tile_size: int,
          max_num: int) -> StagedTiles:
    """The host's share of tiling raw ``[H, W, 3]`` images in [0, 1]: each
    made uint8 and its grid chosen, as ``data/tiling.dynamic_tile`` does.
    An image object given again (a batch's pad rows) is converted once."""
    made: dict = {}
    arrs = [made[id(im)] if id(im) in made
            else made.setdefault(id(im), to_uint8(im)) for im in images]
    grids = [tile_grid(a.shape[0], a.shape[1], tile_size, 1, max_num)
             for a in arrs]
    return StagedTiles(arrs, grids, tile_size, max_num)
