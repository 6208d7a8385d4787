"""The flash kernels' share of their roofline in the traced training
step: the summed bound time of every forward (the remat recompute's
included), dq and dkv launch (``peaks.flash_*_bound`` at the step's real
image prompt lengths) over the summed time of those kernels in the trace,
in %. Nothing where a kernel's count in the profile differs from its
launches."""


def read(layer):
    tr = layer.get("trace")
    bounds = layer.get("flash_bounds_s")
    if tr is None or not bounds:
        return None
    bound = seconds = 0.0
    for kernel, name in layer["flash_names"].items():
        s, n = tr.kernel_s(name)
        if n != len(bounds[kernel]):
            return None
        bound += sum(bounds[kernel])
        seconds += s
    return 100.0 * bound / seconds if seconds > 0 else None
