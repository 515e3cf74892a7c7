"""What the readers of the program's always-on counters share: a counter
of the port's ``repro_torch.tracing`` read before and after the window,
per request.  Reading a counter turns no span on, so a traced run whose
only program readers are these measures the program with its spans off.
Where the program has no ``repro_torch.tracing``, or its tracing has no
such counter (a checkout older than the counter), every reading is
None."""
from __future__ import annotations


def _count(name: str):
    """The counter ``name`` now, or None where the program has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()["counters"].get(name)


def start(ctx, name: str) -> None:
    """Keep where the counter ``name`` stands before the window."""
    ctx.counters["counter." + name] = _count(name)


def per_request(ctx, name: str):
    """Per request, the counter's increase over the window (0 where it
    did not move); None where the program has no such counter or the
    window no request."""
    before, now = ctx.counters.get("counter." + name), _count(name)
    if before is None or now is None or not ctx.window.requests:
        return None
    return (now - before) / ctx.window.requests
