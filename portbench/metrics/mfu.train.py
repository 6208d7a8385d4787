"""The training job's share of the card's bf16 peak over the window: the
model FLOPs of its steps (the decoder forward and its input gradients over
both prompts' real tokens, the LoRA paths forward and backward, the frozen
vision tower on the real tiles; no recompute, no base-weight gradient) over
the window, in %."""


def read(layer):
    if not layer.get("window_flops") or not layer.get("window_s"):
        return None
    return 100.0 * layer["window_flops"] / layer["window_s"] \
        / layer["peak_flops"]
