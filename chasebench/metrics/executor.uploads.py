"""executor.uploads: per request, the program's counter ``uploads``: the
host-to-device copies of the execute path."""
from chasebench import program_trace


def before_window(ctx):
    program_trace.start(ctx)


def read(ctx):
    return program_trace.per_request(ctx, "uploads")
