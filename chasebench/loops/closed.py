"""A closed loop of one client: the next request goes out when the last
one's answer is ready on the host's side (``Statement.execute`` and a
synchronisation of the card), for ``seconds`` seconds.  A request that
raises counts as failed, and its error is logged once.  A traced run
profiles the window's first ``trace.TRACED_S`` seconds."""
from __future__ import annotations

import contextlib
import time
import traceback

from chasebench import harness
from chasebench import trace as trace_mod


def run(target, traffic, first: int, seconds: float, trace: bool, sampler,
        sync, log) -> "harness.Window":
    """Requests ``first``, ``first`` + 1, ... of ``traffic`` until
    ``seconds`` have passed."""
    latencies, failed, queries = [], 0, 0
    prof = trace_mod.profiler() if trace else None
    traced = prof
    i = 0
    if prof is not None:
        prof.start()        # starting the profiler takes seconds on a card
    begin = time.perf_counter()
    while True:
        binds, rows = traffic.request(first + i)
        with trace_mod.span() if prof is not None else \
                contextlib.nullcontext():
            t0 = time.perf_counter()
            try:
                answer = target.execute(binds)
                sync()
            except Exception:                          # noqa: BLE001
                if not failed:
                    log("request failed:\n" + traceback.format_exc())
                failed += 1
                answer = None
            t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if answer is not None:
            queries += traffic.per_request
            sampler.offer(rows, answer)
        i += 1
        if prof is not None and (t1 - begin >= trace_mod.TRACED_S
                                 or t1 - begin >= seconds):
            prof.stop()
            prof = None
        if t1 - begin >= seconds:
            break
    return harness.Window(latencies, i, failed, queries, t1 - begin,
                          trace_mod.events(traced) if trace else None)
