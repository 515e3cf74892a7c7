"""aten.device_ms: per request, the device milliseconds of every kernel an
``aten::`` operator launched and of every copy and set: the plain torch
work around the port's own kernels.  In the flat Q1 cell that is the
predicate's mask and the binds' uploads; in the flat Q2 cell the same
plus stage 2's sort and compaction; in an IVF cell the probe rounds.
Nothing when the window ran none."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.executes or t.other_device_s <= 0:
        return None
    return t.other_device_s / t.executes * 1e3
