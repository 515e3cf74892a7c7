"""executor.syncs: per request, the program's counter ``syncs``: the
points where the execute path waits for the card's stream (each blocking
upload, each host read of a device value, each IVF active check)."""
from chasebench import program_trace


def before_window(ctx):
    program_trace.start(ctx)


def read(ctx):
    return program_trace.per_request(ctx, "syncs")
