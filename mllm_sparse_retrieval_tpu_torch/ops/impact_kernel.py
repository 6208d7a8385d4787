"""Term-at-a-time impact scoring: the hand-written CUDA kernel and its plain
PyTorch version.

``scores[b, n] = sum_j q_w[b, j] * matrix[q_idx[b, j], n]`` over a
``[T+1, N]`` impact matrix (int16 or f32) whose row 0 is a dead zero row;
``q_idx`` is already shifted by +1 and padding slots point at row 0 with
weight 0. The kernel (``csrc/taat.cu``) replaces the JAX package's Pallas
``_taat_kernel``; its design notes are in the source. ``taat_split`` picks
its launch geometry: how many parts a block splits a query's terms into, so
that a small batch still fills the card.

``impact_scores_taat`` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; there is no fallback.
Every launch adds one to the module's launch count, which a run reads to
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.ops import cuda_build

SOURCE = "taat.cu"
COLS_ALIGN = 8   # each kernel thread owns 8 consecutive columns
BLOCK_COLS = 2048         # columns of a 256-thread block at split 1
SPLITS = (1, 2, 4, 8)     # the kernel's term splits (csrc/taat.cu)
FILL_BLOCKS_PER_SM = 3    # blocks a small batch is split to give each SM

_count_lock = threading.Lock()
_launches = 0
_lib = None
_sm_counts = {}


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        args = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.taat_i16, lib.taat_f32):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.taat_error_string.argtypes = [ctypes.c_int]
        lib.taat_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def taat_split(batch: int, n_cols: int, sms: int) -> int:
    """The kernel's term split for a ``[batch, n_cols]`` call on a card of
    ``sms`` SMs: the least split whose blocks (one per query and tile of
    ``BLOCK_COLS / split`` columns) give every SM ``FILL_BLOCKS_PER_SM``,
    else the largest. On an H100 (132 SMs) a served batch of 8 queries
    over 26,624 docs gets 4, the best of the four there, and a bench batch
    of 256 gets 1 (PERF.md)."""
    for split in SPLITS:
        tiles = -(-n_cols // (BLOCK_COLS // split))
        if batch * tiles >= sms * FILL_BLOCKS_PER_SM:
            return split
    return SPLITS[-1]


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def _check_inputs(matrix: torch.Tensor, q_idx: torch.Tensor,
                  q_w: torch.Tensor) -> None:
    if matrix.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"matrix must be int16 or float32, got {matrix.dtype}")
    if q_idx.dtype != torch.int32:
        raise TypeError(f"q_idx must be int32, got {q_idx.dtype}")
    if q_w.dtype != torch.float32:
        raise TypeError(f"q_w must be float32, got {q_w.dtype}")
    if matrix.dim() != 2 or q_idx.dim() != 2 or q_idx.shape != q_w.shape:
        raise ValueError(
            f"need matrix [T+1, N] and q_idx/q_w [B, Q] of one shape; got "
            f"{tuple(matrix.shape)}, {tuple(q_idx.shape)}, "
            f"{tuple(q_w.shape)}")
    if not (matrix.device == q_idx.device == q_w.device):
        raise ValueError(
            f"inputs on different devices: {matrix.device}, {q_idx.device}, "
            f"{q_w.device}")


def impact_scores_taat_plain(matrix: torch.Tensor, q_idx: torch.Tensor,
                             q_w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: adds one weighted row per query slot, in slot
    order, in f32 — the kernel's arithmetic without its data movement."""
    _check_inputs(matrix, q_idx, q_w)
    b, q = q_idx.shape
    scores = torch.zeros((b, matrix.shape[1]), dtype=torch.float32,
                         device=matrix.device)
    idx = q_idx.long()
    for j in range(q):
        scores += q_w[:, j, None] * matrix[idx[:, j]].float()
    return scores


def impact_scores_taat(matrix: torch.Tensor, q_idx: torch.Tensor,
                       q_w: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` f32 term-at-a-time impact scores.

    ``matrix``: ``[T+1, N]`` int16 or f32 (row 0 all zero), ``q_idx``:
    ``[B, Q]`` int32 rows (ids + 1; padding 0), ``q_w``: ``[B, Q]`` f32.
    On CUDA, N must be a multiple of 8 and every tensor contiguous; rows
    outside ``[1, T+1)`` are skipped by the kernel (the plain version
    raises on them instead).
    """
    _check_inputs(matrix, q_idx, q_w)
    if matrix.device.type == "cpu":
        return impact_scores_taat_plain(matrix, q_idx, q_w)
    if matrix.device.type != "cuda":
        raise ValueError(f"no TAAT kernel for device {matrix.device}")
    n_rows, n_cols = matrix.shape
    b, q = q_idx.shape
    if n_cols % COLS_ALIGN:
        raise ValueError(f"doc columns {n_cols} % {COLS_ALIGN} != 0")
    for name, t in (("matrix", matrix), ("q_idx", q_idx), ("q_w", q_w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if matrix.data_ptr() % 16:
        raise ValueError("matrix storage must be 16-byte aligned")
    out = torch.empty((b, n_cols), dtype=torch.float32, device=matrix.device)
    if b == 0:
        return out
    lib = _library()
    fn = lib.taat_i16 if matrix.dtype == torch.int16 else lib.taat_f32
    split = taat_split(b, n_cols, _sm_count(matrix.device))
    with torch.cuda.device(matrix.device):
        stream = torch.cuda.current_stream(matrix.device).cuda_stream
        rc = fn(matrix.data_ptr(), q_idx.data_ptr(), q_w.data_ptr(),
                out.data_ptr(), n_rows, n_cols, b, q, split, stream)
    if rc != 0:
        msg = lib.taat_error_string(rc).decode()
        raise RuntimeError(f"TAAT kernel launch failed ({rc}): {msg}")
    global _launches
    with _count_lock:
        _launches += 1
    return out


def prepare_query_arrays(q_idx, q_w):
    """Shift term ids to matrix rows (+1) and route non-positive weights to
    the dead row 0 (numpy in, numpy out; the matmul backend's
    ``_query_table`` applies the same rule)."""
    q_idx = np.asarray(q_idx)
    q_w = np.asarray(q_w, np.float32)
    safe = np.where(q_w > 0, q_idx + 1, 0).astype(np.int32)
    return safe, np.where(q_w > 0, q_w, 0.0).astype(np.float32)
