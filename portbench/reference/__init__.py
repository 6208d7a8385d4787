"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy in float32 with TF32 off, written from the
published descriptions and the configuration files' widths. It imports
nothing of the port, of JAX or of the JAX package, and takes nothing the
program made: it reads the weights and inputs the benchmark made from the
seed, works out again whatever the port derives from them (token ids,
candidate terms, positions) by frozen copies of those rules, and reads the
program's outputs only to judge them.
"""

import torch


def strict_f32() -> None:
    """Float32 products in float32 (no TF32) from here on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
