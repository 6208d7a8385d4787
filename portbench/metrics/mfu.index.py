"""The indexing job's share of the card's bf16 peak over the window: the
model FLOPs of its images (the vision tower on real patches or tiles, the
projector, the decoder over each real prompt and the LM head at its last
position; ``flops``) over the window's host clock, in %."""


def read(layer):
    if not layer.get("window_flops") or not layer.get("window_s"):
        return None
    return 100.0 * layer["window_flops"] / layer["window_s"] \
        / layer["peak_flops"]
