"""Host milliseconds per step of the optimizer in the traced step: the
``optimizer`` spans of ``train_on_batch`` (clipping and the per-leaf
Adam launches, ``train/trainer.py``) over the ``train_step`` spans. Read
in the profiled slice, whose profiler slows the host: an upper reading."""

from portbench import spanlog


def read(layer, log=None):
    steps = spanlog.named(log, "train_step")
    updates = spanlog.named(log, "optimizer")
    if not steps or not updates:
        return None
    return spanlog.host_ms(updates) / len(steps)
