"""The device's idle share of the traced chunk: 100 x (1 - the union of
its operations' intervals over the chunk's length)."""


def read(layer):
    tr = layer.get("trace")
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
