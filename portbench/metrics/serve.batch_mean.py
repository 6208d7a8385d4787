"""Real queries per served micro-batch over the window, from the
batcher's counters (``MicroBatcher.stats``: batches and items)."""


def read(layer):
    batches = layer.get("serve_batches")
    return layer["serve_items"] / batches if batches else None
