"""The products of the reference's linear layers: float32, or the
control's float8.

The configurations state bfloat16. The nearest precision below it is
float8 (e4m3), the step that would tempt a later change, so the control is
this reference with every linear layer's input and weight rounded to e4m3
(a scale per input row and per weight column, so each slice's largest
value maps to e4m3's largest, 448) and the product taken in float32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) rounded to e4m3 with one scale per slice along
    ``dim``'s complement: the slices reduced over ``dim``. Gradients pass
    straight through the rounding, as in training at that precision."""
    with torch.no_grad():
        amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        scale = amax / E4M3_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach() if x.requires_grad else q


class Linear:
    """``x @ w (+ b)`` in float32, or with ``fp8`` the control's rounding
    of ``x`` per row and ``w`` per output column first."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor = None) -> torch.Tensor:
        x = x.float()
        w = w.float()
        if self.fp8:
            x = fp8_round(x, dim=-1)
            w = fp8_round(w, dim=0)
        y = x @ w
        return y if b is None else y + b.float()
