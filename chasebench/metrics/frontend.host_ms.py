"""frontend.host_ms: per request, the self host milliseconds of the
program's span ``repro_torch.execute``: ``Statement.execute`` less the spans
inside it (the front door, the dispatch, the result)."""
from chasebench import program_trace


def before_window(ctx):
    program_trace.start(ctx)


def read(ctx):
    return program_trace.host_ms(ctx, "repro_torch.execute", "self_s")
