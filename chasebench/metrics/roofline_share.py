"""roofline_share: the least time of the requests' needed work (see
``chasebench/roofline.py``) over the device-busy time of their spans, in
percent.  Nothing on a card the peak table does not hold."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.request_bound_s is None or not t.executes:
        return None
    busy = sum(t.busy_in_span_s)
    return 100.0 * ctx.request_bound_s * t.executes / busy if busy else None
