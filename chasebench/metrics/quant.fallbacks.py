"""quant.fallbacks: per request, the program's counter
``quant_fallbacks``: the quantized range calls whose band passed the
replay budget, answered by the fp32 range kernel instead.  The counter is
always on, so this reader turns no span on.  Nothing on a program without
the counter."""
from chasebench import program_counter

COUNTER = "quant_fallbacks"


def before_window(ctx):
    program_counter.start(ctx, COUNTER)


def read(ctx):
    return program_counter.per_request(ctx, COUNTER)
