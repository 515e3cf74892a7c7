"""kernels.device_ms: per request, the device milliseconds of kernels that
no ``aten::`` operator launched (the port's own CUDA kernels, launched
through ctypes, and any Triton kernel): a kernel whose launch the profiler
links to no host operation, or to one that is not ``aten::``, copies and
sets excepted.  Nothing when the window ran none."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.executes or t.port_kernel_s <= 0:
        return None
    return t.port_kernel_s / t.executes * 1e3
