"""quant.band_rows: per request, the program's counter
``quant_band_rows``: the rows of a quantized range list's slack band (its
maybe rows, certain hits and boundary rows, summed over the list's
queries), read in the same host copy that picks the replay or the fp32
fallback.  The counter is always on, so this reader turns no span on.
Nothing on a program without the counter."""
from chasebench import program_counter

COUNTER = "quant_band_rows"


def before_window(ctx):
    program_counter.start(ctx, COUNTER)


def read(ctx):
    return program_counter.per_request(ctx, COUNTER)
