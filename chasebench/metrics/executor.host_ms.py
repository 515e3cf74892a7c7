"""executor.host_ms: per request, the span's milliseconds in which the
card ran nothing (the span less the union of device work inside it),
averaged over the traced window's requests."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.executes:
        return None
    return (t.span_s - sum(t.busy_in_span_s)) / t.executes * 1e3
