"""What the readers of the program's own spans and counters share: the
port's ``repro_torch.tracing`` turned on before the window, and the
window's part of its table and counters, per request.

A reader's ``before_window`` calls :func:`start`; its ``read`` one of
:func:`host_ms`, :func:`device_ms` or :func:`per_request`.  Where the
program has no ``repro_torch.tracing`` (a checkout older than its spans),
:func:`start` does nothing and every reading is None.  Readers run only in
a ``--trace 1`` run, so an untraced run never turns the spans on.
"""
from __future__ import annotations

KEY = "repro_torch.tracing"


def _tracing():
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def start(ctx) -> None:
    """Turn the program's spans on and keep where its table stands."""
    tracing = _tracing()
    if tracing is not None:
        tracing.enable()
        ctx.counters[KEY] = tracing.snapshot()


def window(ctx):
    """(spans, counters) of the window: each row and counter now less the
    same before the window; None where the program has no spans or the
    window no request."""
    tracing = _tracing()
    before = ctx.counters.get(KEY)
    if tracing is None or before is None or not ctx.window.requests:
        return None
    now = tracing.snapshot()
    spans = {}
    for name, row in now["spans"].items():
        old = before["spans"].get(name, {})
        spans[name] = {k: v - old.get(k, 0) for k, v in row.items()}
    counters = {k: v - before["counters"].get(k, 0)
                for k, v in now["counters"].items()}
    return spans, counters


def host_ms(ctx, prefix: str, field: str = "host_s"):
    """Per request, the milliseconds of ``field`` (``host_s`` or
    ``self_s``) summed over the spans named ``prefix`` or starting with
    it where it ends in a dot; 0 where none ran."""
    got = window(ctx)
    if got is None:
        return None
    spans, _ = got
    seconds = sum(row[field] for name, row in spans.items()
                  if name == prefix
                  or (prefix.endswith(".") and name.startswith(prefix)))
    return seconds / ctx.window.requests * 1e3


def device_ms(ctx, name: str):
    """Per request, the device milliseconds of the span ``name`` (the
    card's stream across it); None where it was never timed on a card."""
    got = window(ctx)
    if got is None:
        return None
    row = got[0].get(name)
    if row is None or row["device_calls"] <= 0:
        return None
    return row["device_s"] / ctx.window.requests * 1e3


def per_request(ctx, counter: str):
    """Per request, the counter's increase over the window (0 where it
    did not move)."""
    got = window(ctx)
    if got is None or counter not in got[1]:
        return None
    return got[1][counter] / ctx.window.requests
