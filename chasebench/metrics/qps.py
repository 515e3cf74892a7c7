"""qps: queries answered in the window over the window's seconds, first
request's start to last request's end, on the host clock."""


def read(ctx):
    w = ctx.window
    return w.queries / w.seconds if w.queries else None
