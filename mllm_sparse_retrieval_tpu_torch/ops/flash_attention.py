"""Causal flash attention, forward and backward: the hand-written CUDA
kernels, their plain PyTorch versions and the autograd Function that joins
them.

``out[b, t, h] = sum_s softmax_s(scale * q[b,t,h] . k[b,s,h/G]) v[b,s,h/G]``
over the admissible keys: ``s <= t`` with ``mask[b, s] != 0`` (``G = Hq /
Hkv``). This is the JAX package's ``layers.attention`` +
``causal_padding_mask``: a pad query attends to every real key at or before
it. The kernels (``csrc/flash_attn.cu``, forward; ``csrc/flash_attn_bwd.cu``,
the dq and dkv backward kernels) replace the stock Pallas TPU flash kernel
that the JAX package's ``layers.flash_causal_attention`` calls; their design
notes are in the sources.

A query with no admissible key (an all-pad row, or a position before the
first real token) is where the three disagree, and no caller reads such a
row: the kernel and the plain version give an output of 0 there (and a
gradient of 0), the forward kernel's log-sum-exp is +inf there; JAX
``attention`` gives the uniform average of ``v`` over all ``T`` keys, since
every logit of the row is ``finfo.min``.

``FlashCausalAttention`` is the differentiable entry. For tensors on the CPU
its forward is the plain version and its backward autograd through the plain
version. For CUDA tensors it launches the kernels or raises; there is no
fallback. Every launch adds one to that kernel's count (``launch_count``),
which a run reads to show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from mllm_sparse_retrieval_tpu_torch.ops import cuda_build

SOURCE = "flash_attn.cu"
BWD_SOURCE = "flash_attn_bwd.cu"
KERNELS = ("fwd", "dq", "dkv")
HEAD_DIM = 128          # the only head width the kernels take
# the plain version materialises [B, heads, T, T] f32 logits one KV-head
# group at a time, and at most this many logit elements per chunk
_PLAIN_CHUNK_ELEMS = 1 << 28

_count_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)
_libs = {}


def launch_count(kernel: str = "fwd") -> int:
    """Launches of ``kernel`` (``"fwd"``, ``"dq"`` or ``"dkv"``) since the
    last ``reset_launch_count``."""
    return _launches[kernel]


def reset_launch_count() -> None:
    with _count_lock:
        for name in KERNELS:
            _launches[name] = 0


def _count(*kernels: str) -> None:
    with _count_lock:
        for name in kernels:
            _launches[name] += 1


def _library(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        lib = cuda_build.load(source)
        if source == SOURCE:
            fn, err = lib.flash_attn_fwd_bf16, lib.flash_attn_error_string
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 12
                           + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                   ctypes.c_void_p])
        else:
            fn, err = lib.flash_attn_bwd_bf16, lib.flash_attn_bwd_error_string
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


def _check_inputs(q, k, v, mask) -> None:
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
    if tuple(mask.shape) != (b, t):
        raise ValueError(f"mask must be [B, T] = {(b, t)}, got "
                         f"{tuple(mask.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device == mask.device):
        raise ValueError(f"inputs on different devices: {q.device}, "
                         f"{k.device}, {v.device}, {mask.device}")


def flash_causal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, mask: torch.Tensor,
                                 *, scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version: f32 logits, the key-mask rule, f32 softmax,
    probabilities cast to the input dtype, then the product with V (the JAX
    ``layers.attention`` arithmetic); a row with no admissible key gives 0.
    One KV-head group at a time (and query rows in chunks), so the f32
    logits of a long sequence need not fit at once. Differentiable: the
    plain backward is autograd through it."""
    _check_inputs(q, k, v, mask)
    b, t, hq, dh = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    real = mask.bool()
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
                & real[:, None, None, :]                      # [B, 1, R, S]
            logits = logits.masked_fill(~ok, torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, dim=-1) * ok.any(-1, keepdim=True)
            out[:, r0:r1, g * rep:(g + 1) * rep] = torch.einsum(
                "bgrs,bsd->brgd", probs.to(q.dtype), vg)
    return out


def flash_causal_attention_plain_bwd(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, mask: torch.Tensor,
                                     dout: torch.Tensor, *,
                                     scale: Optional[float] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """``(dq, dk, dv)``: ``torch.autograd.grad`` of the plain version with
    respect to q, k and v, for the output gradient ``dout`` (GQA: dk and dv
    summed over each group). The oracle of the backward kernels."""
    with torch.enable_grad():
        qd, kd, vd = (x.detach().requires_grad_() for x in (q, k, v))
        out = flash_causal_attention_plain(qd, kd, vd, mask, scale=scale)
        return torch.autograd.grad(out, (qd, kd, vd), dout)


@torch.no_grad()
def flash_bwd_magnitudes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor, dout: torch.Tensor, *,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``(mq, mk, mv)`` shaped like ``(dq, dk, dv)``: the sums of the
    magnitudes of the terms each gradient adds up, for tolerance gates.
    With ``A_ts = |dout_t| . |v_s|`` (which bounds ``|dP_ts|``),
    ``R_t = sum_s P_ts A_ts`` (which bounds ``|di_t|`` and the effect on it
    of rounding the output) and ``W = P * (A + R)``: ``mq = scale * W |k|``,
    ``mk = scale * W^T |q|``, ``mv = P^T |dout|``. A rounding of relative
    size ``u`` in P, dP, di or dS moves each gradient by at most about
    ``u`` times these."""
    _check_inputs(q, k, v, mask)
    b, t, hq, dh = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    real = mask.bool()
    pos = torch.arange(t, device=q.device)
    mq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    mk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    mv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    rows = max(1, min(t, _PLAIN_CHUNK_ELEMS // max(1, b * rep * t)))
    for g in range(hkv):
        kg, vg = k[:, :, g].float(), v[:, :, g].float()
        heads = slice(g * rep, (g + 1) * rep)
        for r0 in range(0, t, rows):
            r1 = min(t, r0 + rows)
            qg = q[:, r0:r1, heads].float()
            dg = dout[:, r0:r1, heads].float()
            logits = torch.einsum("brgd,bsd->bgrs", qg, kg) * scale
            ok = (pos[None, None, r0:r1, None] >= pos[None, None, None, :]) \
                & real[:, None, None, :]
            logits = logits.masked_fill(~ok, torch.finfo(torch.float32).min)
            p = torch.softmax(logits, dim=-1) * ok.any(-1, keepdim=True)
            del logits
            dp = torch.einsum("brgd,bsd->bgrs", dg.abs(), vg.abs())
            w = p * (dp + (p * dp).sum(-1, keepdim=True))
            del dp
            mq[:, r0:r1, heads] = scale * torch.einsum("bgrs,bsd->brgd", w,
                                                       kg.abs())
            mk[:, :, g] += scale * torch.einsum("bgrs,brgd->bsd", w,
                                                qg.abs())
            mv[:, :, g] += torch.einsum("bgrs,brgd->bsd", p, dg.abs())
    return mq, mk, mv


def _check_kernel_inputs(*tensors) -> None:
    q = tensors[0]
    if q.shape[3] != HEAD_DIM:
        raise ValueError(f"the flash kernel takes head_dim {HEAD_DIM}, got "
                         f"{q.shape[3]}")
    for x in tensors:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the flash kernel takes bfloat16, got {x.dtype}")
        if x.stride(3) != 1:
            raise ValueError("every input must have a contiguous last "
                             "dimension")
        if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError("input strides must be multiples of 8 "
                             "elements and their storage 16-byte aligned")


def _tma_view(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a contiguous copy of it where a dimension of extent > 1 has
    stride 0 (a broadcast): the kernels read their inputs through TMA
    tensor maps, which take no zero stride."""
    if any(s == 0 and n > 1 for s, n in zip(x.stride(), x.shape)):
        return x.contiguous()
    return x


def _raise_on(rc: int, lib, name: str, kernel: str) -> None:
    if rc != 0:
        msg = getattr(lib, name)(rc).decode()
        raise RuntimeError(f"flash attention {kernel} kernel launch failed "
                           f"({rc}): {msg}")


def _scale(scale, dh) -> float:
    return float(1.0 / math.sqrt(dh) if scale is None else scale)


def _forward_kernel(q, k, v, mask, scale, want_lse: bool):
    """Launch the forward kernel: ``(out, lse or None)``."""
    _check_kernel_inputs(q, k, v)
    q, k, v = (_tma_view(x) for x in (q, k, v))
    b, t, hq, dh = q.shape
    seg = mask.to(torch.int32).contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device) \
        if want_lse else None
    if b == 0 or t == 0:
        return out, lse
    lib = _library(SOURCE)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attn_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            seg.data_ptr(), lse.data_ptr() if want_lse else None,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], b, t, hq, k.shape[2], _scale(scale, dh),
            stream)
    _raise_on(rc, lib, "flash_attn_error_string", "forward")
    _count("fwd")
    return out, lse


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """``[B, T, Hq, Dh]`` causal attention under the key-mask rule, forward
    only (no log-sum-exp).

    q: ``[B, T, Hq, Dh]``, k/v: ``[B, T, Hkv, Dh]`` (GQA, Hq a multiple of
    Hkv), mask: ``[B, T]`` padding mask (pad 0, real nonzero). On CUDA the
    inputs must be bf16 with head_dim 128, a contiguous last dimension and
    strides that are multiples of 8; the output is a new contiguous bf16
    tensor.
    """
    _check_inputs(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_causal_attention_plain(q, k, v, mask, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    return _forward_kernel(q, k, v, mask, scale, want_lse=False)[0]


def flash_causal_attention_lse(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, mask: torch.Tensor, *,
                               scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel with its log-sum-exp output: ``(out, lse)``, lse
    f32 ``[B, Hq, T]`` = ``log sum_s exp(scale * q . k_s)`` over the
    admissible keys (natural base; +inf where there is none). CUDA only."""
    _check_inputs(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    return _forward_kernel(q, k, v, mask, scale, want_lse=True)


def flash_bwd_di(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``di[b, h, t] = sum_d out . dout`` in f32, contiguous ``[B, Hq, T]``:
    the row term of the backward (the JAX custom VJP's ``jnp.sum`` outside
    its kernels)."""
    return torch.einsum("bthd,bthd->bht", out.float(), dout.float()) \
        .contiguous()


def _backward_kernels(q, k, v, mask, lse, di, dout, scale, which):
    """Launch the dkv and/or dq kernel (``which`` names them); returns
    ``(dq or None, dk or None, dv or None)``."""
    _check_inputs(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, dout)
    q, k, v, dout = (_tma_view(x) for x in (q, k, v, dout))
    b, t, hq, dh = q.shape
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must match q "
                         f"{tuple(q.shape)}")
    for name, x in (("lse", lse), ("di", di)):
        if x.shape != (b, hq, t) or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name} must be contiguous f32 {(b, hq, t)} "
                             f"on {q.device}")
    seg = mask.to(torch.int32).contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) \
        if "dq" in which else None
    dk = torch.empty_like(k, memory_format=torch.contiguous_format) \
        if "dkv" in which else None
    dv = torch.empty_like(v, memory_format=torch.contiguous_format) \
        if "dkv" in which else None
    if b == 0 or t == 0:
        return dq, dk, dv
    strides = []
    for x in (q, k, v, dout, dq if dq is not None else q,
              dk if dk is not None else k, dv if dv is not None else v):
        strides += list(x.stride()[:3])
    st = (ctypes.c_longlong * 21)(*strides)
    lib = _library(BWD_SOURCE)
    ptr = (lambda x: None if x is None else x.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attn_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            ptr(dq), ptr(dk), ptr(dv), seg.data_ptr(), lse.data_ptr(),
            di.data_ptr(), ctypes.addressof(st), b, t, hq, k.shape[2],
            _scale(scale, dh), stream)
    _raise_on(rc, lib, "flash_attn_bwd_error_string", "+".join(which))
    _count(*which)
    return dq, dk, dv


def flash_attention_bwd_dq(q, k, v, mask, lse, di, dout, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The dq kernel alone: ``dq [B, T, Hq, Dh]`` bf16, from the forward's
    ``lse`` and ``di = flash_bwd_di(out, dout)``."""
    return _backward_kernels(q, k, v, mask, lse, di, dout, scale,
                             ("dq",))[0]


def flash_attention_bwd_dkv(q, k, v, mask, lse, di, dout, *,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dkv kernel alone: ``(dk, dv)``, each ``[B, T, Hkv, Dh]`` bf16,
    summed over each GQA group."""
    return _backward_kernels(q, k, v, mask, lse, di, dout, scale,
                             ("dkv",))[1:]


def flash_causal_attention_bwd(q, k, v, mask, out, lse, dout, *,
                               scale: Optional[float] = None):
    """Both backward kernels: ``(dq, dk, dv)`` from the forward's ``out``
    and ``lse`` (``flash_causal_attention_lse``). CUDA only; raises on
    inputs the kernels do not take."""
    _check_kernel_inputs(out)
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} must match q "
                         f"{tuple(q.shape)}")
    return _backward_kernels(q, k, v, mask, lse, flash_bwd_di(out, dout),
                             dout, scale, ("dkv", "dq"))


class FlashCausalAttention(torch.autograd.Function):
    """Differentiable causal flash attention:
    ``FlashCausalAttention.apply(q, k, v, mask, scale)``.

    CUDA: the forward kernel (with its log-sum-exp when a gradient is
    needed) and, in backward, the dkv and dq kernels. CPU: the plain version
    forward and autograd through it backward.
    """

    @staticmethod
    def forward(ctx, q, k, v, mask, scale=None):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, mask)
            return flash_causal_attention_plain(q, k, v, mask, scale=scale)
        if not any(ctx.needs_input_grad[:3]):
            return flash_causal_attention(q, k, v, mask, scale=scale)
        out, lse = flash_causal_attention_lse(q, k, v, mask, scale=scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        if len(saved) == 4:
            q, k, v, mask = saved
            grads = flash_causal_attention_plain_bwd(q, k, v, mask, dout,
                                                     scale=ctx.scale)
        else:
            q, k, v, mask, out, lse = saved
            grads = flash_causal_attention_bwd(q, k, v, mask, out, lse,
                                               dout.contiguous(),
                                               scale=ctx.scale)
        return (*grads, None, None)
