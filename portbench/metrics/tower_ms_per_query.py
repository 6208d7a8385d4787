"""Device milliseconds inside the decoder's ``tower`` ranges per query
served in the traced slice (the port marks the decoder stack with
``record_function("tower")``; queries from the batcher's counters)."""


def read(layer):
    tr = layer.get("trace")
    if tr is None or not layer.get("slice_queries"):
        return None
    seconds, spans = tr.span_s("tower")
    if spans == 0 or seconds <= 0:
        return None
    return seconds * 1e3 / layer["slice_queries"]
