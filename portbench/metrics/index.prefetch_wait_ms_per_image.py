"""Host milliseconds per image that the encode loop spent waiting for
the prefetch thread in the traced chunk: the ``prefetch_wait`` spans
(``ops/stream.py``), the preprocessing the pipeline failed to hide, over
the chunk's images. Read in the profiled slice, whose profiler slows the
host: an upper reading."""

from portbench import spanlog


def read(layer, log=None):
    waits = spanlog.named(log, "prefetch_wait")
    if not waits or not layer.get("images"):
        return None
    return spanlog.host_ms(waits) / layer["images"]
