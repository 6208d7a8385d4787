"""Weight quantization for k-bit base weights (nf4 / int4 / int8): QLoRA.

The JAX package's ``models/quantization.py``, the counterpart of the
reference's bitsandbytes load (``BitsAndBytesConfig(load_in_4bit, nf4,
double_quant)``). Base dense weights are stored quantized and dequantized
per use inside ``layers.dense``, so the resident tree holds the quantized
bytes and one layer's weight at a time exists in the compute dtype; LoRA
adapters stay full precision, so QLoRA is a quantized frozen base plus the
usual adapter tree.

``QuantizedWeight`` is a plain dataclass of tensors with the JAX package's
fields, and answers the shape probes the code makes (``.shape`` / ``.ndim``
are the logical ``[in, out]``, ``.nbytes`` the stored bytes, ``.dtype`` the
scale's f32, as in the JAX package), so adapters initialise against a
quantized tree.

Three storage modes, byte-compatible with the JAX package:

- ``nf4`` (4-bit, the reference's ``bnb_4bit_quant_type='nf4'`` with double
  quantization): absmax over blocks of 64 input rows per output column,
  4-bit indices into the 16-value NormalFloat code (nearest code by a
  search over the 15 midpoints), the block absmax stored int8 around the
  column's mean with a per-column scale.
- ``linear`` int4: per-output-channel symmetric, two values a byte.
- int8: per-output-channel symmetric.

A weight quantizes to the same bytes on the CPU and on the card: every
division is a true division by a tensor on the weight's device (PyTorch's
CUDA kernels multiply by the reciprocal of a Python-number divisor, which
may differ in the last bit), and the column mean of the double
quantization is summed in float64 and rounded once to f32. The JAX package
sums that mean in f32, which may differ from it in the last bit (then a
``scale_q`` by one step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

# The 16 NormalFloat-4 code values (bitsandbytes' nf4 table), ascending.
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
NF4_BLOCK = 64          # bnb's default 4-bit block size
NF4_SCALE_QMAX = 127.0  # double quant: block absmax stored int8


@dataclass
class QuantizedWeight:
    """A dense ``[in, out]`` weight stored quantized.

    ``q``: int8, ``[in, out]`` for 8-bit, ``[ceil(in/2), out]`` packed
    nibbles for 4-bit (linear int4 values, or nf4 code indices with the
    rows padded to a multiple of 64). ``mode='linear'``: ``scale`` is the
    f32 ``[1, out]`` per-channel scale. ``mode='nf4'``: ``scale_q`` int8
    ``[n_blocks, out]``, ``scale`` f32 ``[1, out]`` and ``scale_off`` f32
    ``[1, out]``; block absmax = ``scale_q * scale + scale_off``.
    ``logical_shape``: the original ``(in, out)``."""

    q: torch.Tensor
    scale: torch.Tensor
    bits: int
    logical_shape: Tuple[int, int]
    scale_q: Optional[torch.Tensor] = None
    scale_off: Optional[torch.Tensor] = None
    mode: str = "linear"

    @property
    def shape(self) -> Tuple[int, int]:
        return self.logical_shape

    @property
    def ndim(self) -> int:
        return len(self.logical_shape)

    @property
    def dtype(self) -> torch.dtype:
        """The scale's dtype (f32), as in the JAX package: callers that
        probe a weight's dtype for their compute dtype (the vision towers'
        patch embeddings) compute in f32 over a quantized weight."""
        return self.scale.dtype

    def tensors(self) -> List[torch.Tensor]:
        """The stored tensors, ``q`` first."""
        return [t for t in (self.q, self.scale, self.scale_q, self.scale_off)
                if t is not None]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def to(self, device) -> "QuantizedWeight":
        def move(t):
            return None if t is None else t.to(device)

        return QuantizedWeight(move(self.q), move(self.scale), self.bits,
                               self.logical_shape, move(self.scale_q),
                               move(self.scale_off), self.mode)


def quantize_weight(w: torch.Tensor, bits: int = 8,
                    mode: str = "linear") -> QuantizedWeight:
    """Quantize an ``[in, out]`` matrix on its device (``linear``:
    per-output-channel symmetric; ``nf4``: the blockwise NormalFloat code,
    4-bit only)."""
    if bits not in (4, 8):
        raise ValueError("bits must be 4 or 8")
    if mode == "nf4":
        if bits != 4:
            raise ValueError("nf4 is a 4-bit format (got bits=8)")
        return _quantize_nf4(w)
    if mode != "linear":
        raise ValueError(f"mode must be 'linear' or 'nf4', got {mode!r}")
    w = w.detach().float()
    qmax = 127.0 if bits == 8 else 7.0
    scale = w.abs().amax(dim=0, keepdim=True) / _scalar(qmax, w)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        q = _pack_int4(q)
    return QuantizedWeight(q=q, scale=scale, bits=bits,
                           logical_shape=tuple(w.shape))


def dequantize_weight(entry: QuantizedWeight,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dense ``[in, out]`` weight in ``dtype``, computed in f32 and
    rounded once."""
    if entry.mode == "nf4":
        return _dequantize_nf4(entry, dtype)
    q = entry.q
    if entry.bits == 4:
        q = _unpack_int4(q, entry.logical_shape[0])
    return (q.float() * entry.scale).to(dtype)


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor on ``like``'s device and dtype: dividing
    by it is a true division on the card too."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _quantize_nf4(w: torch.Tensor) -> QuantizedWeight:
    in_dim, out_dim = w.shape
    w = w.detach().float()
    pad = (-in_dim) % NF4_BLOCK
    if pad:
        w = torch.cat([w, w.new_zeros(pad, out_dim)])
    nb = w.shape[0] // NF4_BLOCK
    blocks = w.view(nb, NF4_BLOCK, out_dim)
    absmax = blocks.abs().amax(dim=1)                      # [nb, out]
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    norm = blocks / safe[:, None, :]                       # in [-1, 1]
    code = torch.tensor(NF4_CODE, dtype=torch.float32, device=w.device)
    mid = (code[1:] + code[:-1]) / 2.0                     # 15 boundaries
    # side 'left' (jnp.searchsorted's default): the count of mids < norm
    idx = torch.searchsorted(mid, norm.reshape(-1), out_int32=True).to(
        torch.uint8)
    del norm
    idx = idx.view(w.shape[0], out_dim)
    # double quant: absmax -> int8 around the column mean (float64 sum)
    total = absmax.double().sum(dim=0, keepdim=True)
    off = (total / _scalar(nb, total)).float()                # [1, out]
    centered = absmax - off
    s2 = centered.abs().amax(dim=0, keepdim=True) / _scalar(NF4_SCALE_QMAX,
                                                            w)
    s2 = torch.where(s2 == 0, torch.ones_like(s2), s2)
    scale_q = torch.clamp(torch.round(centered / s2), -NF4_SCALE_QMAX,
                          NF4_SCALE_QMAX).to(torch.int8)
    return QuantizedWeight(q=_pack_uint4(idx), scale=s2, bits=4,
                           logical_shape=(in_dim, out_dim), scale_q=scale_q,
                           scale_off=off, mode="nf4")


def _dequantize_nf4(entry: QuantizedWeight, dtype) -> torch.Tensor:
    in_dim, out_dim = entry.logical_shape
    idx = _unpack_uint4(entry.q)                           # [in_pad, out]
    code = torch.tensor(NF4_CODE, dtype=torch.float32, device=idx.device)
    vals = code.index_select(0, idx.view(-1).int()).view(idx.shape)
    absmax = entry.scale_q.float() * entry.scale + entry.scale_off
    nb = idx.shape[0] // NF4_BLOCK
    w = vals.view(nb, NF4_BLOCK, out_dim) * absmax[:, None, :]
    return w.view(idx.shape[0], out_dim)[:in_dim].to(dtype)


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """``[in, out]`` int8 in [-7, 7] -> ``[ceil(in/2), out]`` packed nibbles
    (row 2i in the low nibble, row 2i+1 in the high one)."""
    return _pack_uint4(q.view(torch.uint8) & 0x0F)


def _unpack_int4(packed: torch.Tensor, rows: int) -> torch.Tensor:
    u = _unpack_uint4(packed).to(torch.int8)
    return torch.where(u > 7, u - 16, u)[:rows]     # 4-bit two's complement


def _pack_uint4(idx: torch.Tensor) -> torch.Tensor:
    """``[in, out]`` values in 0..15 -> ``[ceil(in/2), out]`` int8 bytes."""
    idx = idx.to(torch.uint8)
    if idx.shape[0] % 2:
        idx = torch.cat([idx, idx.new_zeros(1, idx.shape[1])])
    lo = idx[0::2] & 0x0F
    hi = (idx[1::2] & 0x0F) << 4
    return (lo | hi).view(torch.int8)


def _unpack_uint4(packed: torch.Tensor) -> torch.Tensor:
    """Packed bytes -> ``[2 * rows, out]`` uint8 values in 0..15."""
    u = packed.view(torch.uint8)
    return torch.stack([u & 0x0F, u >> 4], dim=1).view(-1, packed.shape[1])


def _is_quantizable(path_names, leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.dim() == 2
            and str(path_names[-1]) == "w" and leaf.numel() >= 1024)


def quantize_params(params: Dict, bits: int = 8, skip_embed: bool = True,
                    mode: str = "linear") -> Dict:
    """A new tree with every eligible dense weight (a 2-D ``w`` of at least
    1,024 elements) quantized on its device; ``embed`` and ``lm_head`` stay
    full precision unless ``skip_embed=False``. Other leaves are shared
    with ``params``."""

    def visit(tree, path=()):
        if isinstance(tree, dict):
            return {k: v if skip_embed and k in ("embed", "lm_head")
                    else visit(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [visit(v, path + (i,)) for i, v in enumerate(tree)]
        if _is_quantizable(path, tree):
            return quantize_weight(tree, bits, mode=mode)
        return tree

    return visit(params)


def dequantize_params(params: Dict, dtype: torch.dtype = torch.float32
                      ) -> Dict:
    """The tree with every ``QuantizedWeight`` dequantized to ``dtype``
    (other leaves shared). It rematerialises the whole tree: it is for
    export and checks; the forward passes dequantize per use."""

    def visit(tree):
        if isinstance(tree, QuantizedWeight):
            return dequantize_weight(tree, dtype)
        if isinstance(tree, dict):
            return {k: visit(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [visit(v) for v in tree]
        return tree

    return visit(params)


def quantized_bytes(params: Any) -> int:
    """Bytes of a (possibly quantized) tree's tensors."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    if isinstance(params, QuantizedWeight):
        return params.nbytes
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0


def tree_to(params: Any, device) -> Any:
    """A tree of tensors and ``QuantizedWeight``s moved to ``device``."""
    if isinstance(params, dict):
        return {k: tree_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [tree_to(v, device) for v in params]
    if isinstance(params, (QuantizedWeight, torch.Tensor)):
        return params.to(device)
    return params


def quantized_leaves(params: Any) -> List[QuantizedWeight]:
    """The ``QuantizedWeight`` leaves of a tree, in tree order."""
    if isinstance(params, QuantizedWeight):
        return [params]
    if isinstance(params, dict):
        return [x for v in params.values() for x in quantized_leaves(v)]
    if isinstance(params, (list, tuple)):
        return [x for v in params for x in quantized_leaves(v)]
    return []
