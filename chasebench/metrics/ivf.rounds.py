"""ivf.rounds: probe rounds per request, from the port's counter
``repro_torch.index.ivf.loop_stats["rounds"]`` across the window.
Nothing when no round ran."""


def _rounds():
    from repro_torch.index import ivf
    return ivf.loop_stats["rounds"]


def before_window(ctx):
    ctx.counters["ivf.rounds"] = _rounds()


def read(ctx):
    rounds = _rounds() - ctx.counters["ivf.rounds"]
    return rounds / ctx.window.requests if rounds > 0 else None
