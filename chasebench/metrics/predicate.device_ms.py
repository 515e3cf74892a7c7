"""predicate.device_ms: per request, the device milliseconds of the
program's span ``repro_torch.predicate``: the card's stream from the start
of each structured predicate's evaluation into a row mask to its end.
Nothing where no span was timed on a card."""
from chasebench import program_trace


def before_window(ctx):
    program_trace.start(ctx)


def read(ctx):
    return program_trace.device_ms(ctx, "repro_torch.predicate")
