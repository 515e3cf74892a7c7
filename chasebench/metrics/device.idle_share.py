"""device.idle_share: the share of the traced window, first request's span
start to last span end, in which the card ran no kernel, copy or set."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
