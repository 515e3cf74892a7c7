"""stage2.overflows: per request, the program's counter
``range_overflows``: the queries of a batched range compaction that had
more hits than their result buffer and were recomputed on the dense path
(each query's best hits are otherwise sorted on the card).  The program's
counters are always on, so this reader turns no span on: a traced run
without the span readers keeps the spans off.  Nothing on a program
without the counter."""
KEY = "stage2.overflows"


def _count():
    """The counter now, or None where the program has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()["counters"].get("range_overflows")


def before_window(ctx):
    ctx.counters[KEY] = _count()


def read(ctx):
    before, now = ctx.counters.get(KEY), _count()
    if before is None or now is None or not ctx.window.requests:
        return None
    return (now - before) / ctx.window.requests
