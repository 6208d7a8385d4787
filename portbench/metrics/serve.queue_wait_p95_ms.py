"""The 95th percentile of the requests' waits in the micro-batcher's queue
over the window, from each request's submit to its micro-batch's dispatch:
the waits of the window's ``micro_batch`` tallies (``serving/batcher.py``,
kept with tracing off), in ms."""

from portbench import spanlog, stats


def read(layer, tallies=None):
    batches = spanlog.window(layer.get("serve_batches"), "micro_batch",
                             tallies)
    waits = [1e3 * w for b in batches for w in b.get("waits_s", ())]
    return stats.percentile(waits, 95) if waits else None
