"""Host milliseconds of collation per step in the traced step: the
``collate`` spans of ``make_collator``'s collator (tokenizing, tiling,
padding; ``train/trainer.py``) over the ``train_step`` spans. Read in
the profiled slice, whose profiler slows the host: an upper reading."""

from portbench import spanlog


def read(layer, log=None):
    steps = spanlog.named(log, "train_step")
    collates = spanlog.named(log, "collate")
    if not steps or not collates:
        return None
    return spanlog.host_ms(collates) / len(steps)
