"""The flash forward kernel's share of its roofline in the traced chunk:
the summed bound time of its launches (q, k, v, out and the mask moved
once, against the two products over the pairs the causal key mask admits
at each batch's real prompt lengths; ``peaks.flash_fwd_bound``) over the
summed time of the ``flash_fwd`` kernels in the trace, in %. Nothing where
the profile's kernel count differs from the bounds'."""


def read(layer):
    tr = layer.get("trace")
    bounds = layer.get("flash_fwd_bounds_s")
    if tr is None or not bounds:
        return None
    seconds, n = tr.kernel_s("flash_fwd")
    if n != len(bounds) or seconds <= 0:
        return None
    return 100.0 * sum(bounds) / seconds
