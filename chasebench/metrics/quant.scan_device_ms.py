"""quant.scan_device_ms: per request, the device milliseconds of the
program's span ``repro_torch.quant.scan``: the card's stream across the
quantized twin's kernel and its candidate selection (a top-k's best
segments expanded to rows; a range's slack bands, the host read of their
sizes and the two selections of the rows to replay).  Nothing on a program
without the span, or where no span was timed on a card."""
from chasebench import program_trace


def before_window(ctx):
    program_trace.start(ctx)


def read(ctx):
    return program_trace.device_ms(ctx, "repro_torch.quant.scan")
