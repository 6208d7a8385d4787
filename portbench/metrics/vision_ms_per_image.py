"""Device milliseconds inside the ``vision`` ranges (the vision tower,
the merger or projector and the splice) per image encoded in the traced
chunk."""


def read(layer):
    tr = layer.get("trace")
    if tr is None or not layer.get("images"):
        return None
    seconds, spans = tr.span_s("vision")
    if spans == 0 or seconds <= 0:
        return None
    return seconds * 1e3 / layer["images"]
