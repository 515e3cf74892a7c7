"""quant.replayed: per request, the program's counter ``quant_replayed``:
the (query, row) slots replayed in fp32 on the quantized twin's path,
counted from the replay's shapes (pad lanes of the size bucket and empty
slots included), so that counting it waits for nothing.  The counter is
always on, so this reader turns no span on.  Nothing on a program without
the counter."""
from chasebench import program_counter

COUNTER = "quant_replayed"


def before_window(ctx):
    program_counter.start(ctx, COUNTER)


def read(ctx):
    return program_counter.per_request(ctx, COUNTER)
