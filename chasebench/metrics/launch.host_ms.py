"""launch.host_ms: per request, the host milliseconds of every
``repro_torch.kernel.*`` span: each hand-written kernel's wrapper, from its
checks through the ctypes launch."""
from chasebench import program_trace


def before_window(ctx):
    program_trace.start(ctx)


def read(ctx):
    return program_trace.host_ms(ctx, "repro_torch.kernel.")
