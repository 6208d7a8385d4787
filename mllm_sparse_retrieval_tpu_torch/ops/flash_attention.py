"""Causal flash attention, forward: the hand-written CUDA kernel and its plain
PyTorch version.

``out[b, t, h] = sum_s softmax_s(scale * q[b,t,h] . k[b,s,h/G]) v[b,s,h/G]``
over the keys ``s <= t`` whose segment id equals the query's (``G = Hq /
Hkv``). With the padding mask as segment ids (pad 0, real 1), this is what
the JAX package's ``layers.flash_causal_attention`` computes through the
stock Pallas TPU kernel, and it equals ``attention`` + ``causal_padding_mask``
at every non-pad position. The kernel (``csrc/flash_attn.cu``) replaces that
Pallas kernel's forward; its design notes are in the source.

``flash_causal_attention`` takes the plain version only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises; there is no
fallback. Every launch adds one to the module's launch count, which a run
reads to show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from mllm_sparse_retrieval_tpu_torch.ops import cuda_build

SOURCE = "flash_attn.cu"
HEAD_DIM = 128          # the only head width the kernel takes
# the plain version materialises [B, heads, T, T] f32 logits one KV-head
# group at a time, and at most this many logit elements per chunk
_PLAIN_CHUNK_ELEMS = 1 << 28

_count_lock = threading.Lock()
_launches = 0
_lib = None


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
        fn = lib.flash_attn_fwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 4 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_inputs(q, k, v, segment_ids) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need q [B, T, Hq, Dh] and k/v [B, T, Hkv, Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, hq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != t \
            or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[2] < 1 or hq % k.shape[2]:
        raise ValueError(f"q heads {hq} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if tuple(segment_ids.shape) != (b, t):
        raise ValueError(f"mask/segment ids must be [B, T] = {(b, t)}, got "
                         f"{tuple(segment_ids.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device == segment_ids.device):
        raise ValueError(f"inputs on different devices: {q.device}, "
                         f"{k.device}, {v.device}, {segment_ids.device}")


def flash_causal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, segment_ids: torch.Tensor,
                                 *, scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version: f32 logits, causal + same-segment mask, f32
    softmax, probabilities cast to the input dtype, then the product with V
    (the JAX ``layers.attention`` arithmetic). Every query admits at least
    its own key. One KV-head group at a time (and query rows in chunks), so
    the f32 logits of a long sequence need not fit at once."""
    _check_inputs(q, k, v, segment_ids)
    b, t, hq, dh = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    seg = segment_ids.to(torch.int32)
    pos = torch.arange(t, device=q.device)
    out = torch.empty_like(q)
    rows = max(1, min(t, _PLAIN_CHUNK_ELEMS // max(1, b * rep * t)))
    for g in range(hkv):
        kg = k[:, :, g].float()                       # [B, S, Dh]
        vg = v[:, :, g]
        for r0 in range(0, t, rows):
            r1 = min(t, r0 + rows)
            qg = q[:, r0:r1, g * rep:(g + 1) * rep].float()   # [B, R, G, Dh]
            logits = torch.einsum("brgd,bsd->bgrs", qg, kg) * scale
            ok = (pos[None, None, r0:r1, None] >= pos[None, None, None, :]) \
                & (seg[:, None, r0:r1, None] == seg[:, None, None, :])
            logits = logits.masked_fill(~ok, torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, dim=-1)
            out[:, r0:r1, g * rep:(g + 1) * rep] = torch.einsum(
                "bgrs,bsd->brgd", probs.to(q.dtype), vg)
    return out


def _check_kernel_inputs(q, k, v) -> None:
    if q.shape[3] != HEAD_DIM:
        raise ValueError(f"the flash kernel takes head_dim {HEAD_DIM}, got "
                         f"{q.shape[3]}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernel takes bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous last dimension")
        if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name} strides must be multiples of 8 "
                             f"elements and its storage 16-byte aligned")


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           segment_ids: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """``[B, T, Hq, Dh]`` causal attention restricted to equal segment ids.

    q: ``[B, T, Hq, Dh]``, k/v: ``[B, T, Hkv, Dh]`` (GQA, Hq a multiple of
    Hkv), segment_ids: ``[B, T]`` integers (the padding mask: pad 0, real 1).
    On CUDA the inputs must be bf16 with head_dim 128 and a contiguous last
    dimension; the output is a new contiguous bf16 tensor.
    """
    _check_inputs(q, k, v, segment_ids)
    if q.device.type == "cpu":
        return flash_causal_attention_plain(q, k, v, segment_ids, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    _check_kernel_inputs(q, k, v)
    b, t, hq, dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0 or t == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attn_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            seg.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], b, t, hq, k.shape[2],
            float(scale), stream)
    if rc != 0:
        msg = lib.flash_attn_error_string(rc).decode()
        raise RuntimeError(f"flash attention kernel launch failed ({rc}): "
                           f"{msg}")
    global _launches
    with _count_lock:
        _launches += 1
    return out
