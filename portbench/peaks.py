"""The card's published peaks and the least time a kernel could take.

NVIDIA H100 SXM datasheet rates (dense, no sparsity) at its 700 W limit;
a card set below it runs slower, so every result prints the card's power
limit beside its shares. The bound arithmetic is a frozen copy of
``chip_smoke.py``'s (``admissible_pairs``, ``bound``, ``flash_bound``,
``bwd_bound``, ``taat_bound``): operations and bytes from shapes, each
byte read or written once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12       # device memory rate
BF16_OPS_PER_S = 989e12         # bf16 tensor cores
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores


def admissible_pairs(lengths: Sequence[int], t: int) -> int:
    """(query, key) pairs the causal key-mask rule admits over right-padded
    rows of ``lengths`` real tokens in ``t`` positions: query ``i`` sees
    ``min(i + 1, n)`` keys (pad queries included)."""
    return sum(n * (n + 1) // 2 + (t - n) * n for n in lengths)


def bound(ops: float, nbytes: float, ops_per_s: float = BF16_OPS_PER_S
          ) -> Tuple[float, str]:
    """(least seconds for ``ops`` operations and ``nbytes`` of device
    memory traffic, which of the two bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_fwd_bound(lengths, t, hq, hkv, dh=128) -> float:
    """Seconds: q, k, v, out and the mask moved once, against the
    multiply-adds of the two products over the admissible pairs."""
    b = len(lengths)
    ops = 4 * hq * dh * admissible_pairs(lengths, t)
    nbytes = b * t * dh * 2 * (2 * hq + 2 * hkv) + b * t * 4
    return bound(ops, nbytes)[0]


def flash_bwd_bound(lengths, t, hq, hkv, products, out_heads, dh=128
                    ) -> float:
    """Seconds for one backward kernel: ``products`` 128-deep products per
    admissible pair and head (dq: 3, dkv: 4), q, k, v, dout, lse, di and the
    mask read once, ``out_heads`` heads of gradient written once."""
    b = len(lengths)
    ops = 2 * products * hq * dh * admissible_pairs(lengths, t)
    nbytes = (b * t * dh * 2 * (2 * hq + 2 * hkv + out_heads)
              + 2 * b * hq * t * 4 + b * t * 4)
    return bound(ops, nbytes)[0]


def flash_dq_bound(lengths, t, hq, hkv, dh=128) -> float:
    return flash_bwd_bound(lengths, t, hq, hkv, 3, hq, dh)


def flash_dkv_bound(lengths, t, hq, hkv, dh=128) -> float:
    return flash_bwd_bound(lengths, t, hq, hkv, 4, 2 * hkv, dh)


def taat_bound(live_rows: int, live_slots: int, b: int, q: int, n: int,
               elem_bytes: int) -> float:
    """Seconds for one TAAT launch: the ``live_rows`` distinct impact rows
    of ``n`` columns read once, the query arrays ``[b, q]`` read once, the
    ``[b, n]`` f32 scores written once, against ``live_slots`` rows' f32
    multiply-adds."""
    nbytes = live_rows * n * elem_bytes + b * q * 8 + b * n * 4
    ops = 2 * live_slots * n
    return bound(ops, nbytes, F32_OPS_PER_S)[0]
