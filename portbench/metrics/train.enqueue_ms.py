"""Host milliseconds until ``train_on_batch(blocking=False)`` returns, the
mean over the window's steps (the collate before it not counted)."""


def read(layer):
    steps = layer.get("enqueue_s")
    return 1e3 * sum(steps) / len(steps) if steps else None
