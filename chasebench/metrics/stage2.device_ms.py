"""stage2.device_ms: per request, the device milliseconds of the
program's span ``repro_torch.stage2``: the card's stream across each plain
torch step after a kernel (the top-k merge, the range compaction and its
sort).  Nothing where no span was timed on a card."""
from chasebench import program_trace


def before_window(ctx):
    program_trace.start(ctx)


def read(ctx):
    return program_trace.device_ms(ctx, "repro_torch.stage2")
