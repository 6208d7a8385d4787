"""The padded share of the tokens the text encoder launched over the
window: 100 x (1 - real tokens / launched tokens) summed over the window's
``micro_batch`` tallies (``serving/batcher.py``, kept with tracing off),
whose ``tokens_launched`` is each encode call's padded rows times its
padded length (``serving/encoder.py``), in %."""

from portbench import spanlog


def read(layer, tallies=None):
    batches = spanlog.window(layer.get("serve_batches"), "micro_batch",
                             tallies)
    real = sum(b.get("tokens_real", 0) for b in batches)
    launched = sum(b.get("tokens_launched", 0) for b in batches)
    return 100.0 * (1.0 - real / launched) if launched else None
