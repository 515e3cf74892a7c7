"""bind.host_ms: per request, the host milliseconds of the program's span
``repro_torch.bind``: the list of bind dicts stacked on the host."""
from chasebench import program_trace


def before_window(ctx):
    program_trace.start(ctx)


def read(ctx):
    return program_trace.host_ms(ctx, "repro_torch.bind")
