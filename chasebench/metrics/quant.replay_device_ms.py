"""quant.replay_device_ms: per request, the device milliseconds of the
program's span ``repro_torch.quant.replay``: the card's stream across the
fp32 replay of the candidates (``replay_keys``) and the exact re-rank (a
top-k's best K; a range's emission and count).  Nothing on a program
without the span, or where no span was timed on a card."""
from chasebench import program_trace


def before_window(ctx):
    program_trace.start(ctx)


def read(ctx):
    return program_trace.device_ms(ctx, "repro_torch.quant.replay")
