"""The TAAT kernel's share of its roofline in the traced slice: the
summed bound time of each launch (its query rows' distinct impact rows
read once, the query arrays read once, the scores written once, against
its multiply-adds; ``peaks.taat_bound``) over the summed time of the
``taat`` kernels in the trace, in %. Nothing where the profile's kernel
count differs from the launches counted."""


def read(layer):
    tr = layer.get("trace")
    bounds = layer.get("taat_bounds_s")
    if tr is None or not bounds:
        return None
    seconds, n = tr.kernel_s("taat")
    if n != len(bounds) or seconds <= 0:
        return None
    return 100.0 * sum(bounds) / seconds
