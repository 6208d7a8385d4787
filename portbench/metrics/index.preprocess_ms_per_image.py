"""Host milliseconds of preprocessing per image in the traced chunk: the
``preprocess`` spans of ``encode_examples``'s prefetch thread (tiling or
resizing, patches, prompts; ``pipelines/encode.py``) over the images
they count. Read in the profiled slice, whose profiler slows the host:
an upper reading."""

from portbench import spanlog


def read(layer, log=None):
    spans = [s for s in spanlog.named(log, "preprocess")
             if s.attrs.get("images")]
    images = sum(s.attrs["images"] for s in spans)
    return spanlog.host_ms(spans) / images if images else None
