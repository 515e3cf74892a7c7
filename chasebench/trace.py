"""What a ``--trace 1`` run reads from ``torch.profiler``: the benchmark's
span around each request, and every operation the card ran.

``digest`` reduces the profiler's events to the numbers the per-layer
readers take:

* ``spans``: each request's span (the ``record_function`` named ``SPAN``
  that the window opens around an execute and its synchronisation);
* per span, the seconds in which the card ran anything (the union of its
  kernels, copies and sets);
* ``port_kernel_s``: device seconds of kernels that no ``aten::``
  operator launched, the port's own CUDA kernels and any Triton kernel it
  launches; ``other_device_s``: every other kernel, copy and set.  A
  kernel is an ``aten::`` operator's when its linked correlation id is one
  of theirs: the runtime's and the profiler's own host events ("cuda...",
  "Buffer Flush") carry ids from another count that collide with the
  operators', so only the operators' ids are looked up;
* ``busy_s`` and ``window_s`` over the traced window (first span start to
  last span end: the window's first ``TRACED_S`` seconds), and
  ``breakdown``: the device operations that took most time, and the
  longest idle gaps named by the innermost host operation running at
  their middle.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

import torch
from torch.autograd import DeviceType

SPAN = "chasebench.request"
# seconds of a window that a traced run profiles, from its start: enough
# requests for every per-layer mean (about 100 lists of the IVF cell),
# few enough events (some millions a minute in the flat Q2 cell) to read
# back in seconds
TRACED_S = 5.0
# host operations looked back through for the one that covers an idle gap
WALK = 20_000


def profiler():
    """The profiler of a traced window: host operations and the card."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span():
    """The span the window opens around one request."""
    return torch.profiler.record_function(SPAN)


@dataclasses.dataclass
class Digest:
    spans: list            # [(start_ns, end_ns)]
    busy_in_span_s: list   # device-busy seconds inside each span
    port_kernel_s: float
    other_device_s: float
    busy_s: float
    window_s: float
    breakdown: dict

    @property
    def executes(self) -> int:
        return len(self.spans)

    @property
    def span_s(self) -> float:
        return sum(e - s for s, e in self.spans) / 1e9


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals: list, lo: int, hi: int) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def events(prof):
    """The profiler's raw events as (device, name, start_ns, end_ns,
    correlation, linked correlation, thread, annotation)."""
    for ev in prof.profiler.kineto_results.events():
        yield (ev.device_type() == DeviceType.CUDA, ev.name(), ev.start_ns(),
               ev.end_ns(), ev.correlation_id(), ev.linked_correlation_id(),
               ev.start_thread_id(), ev.is_user_annotation())


def digest(raw, top: int = 10) -> Digest | None:
    """Reduce ``events(prof)``; None when the window holds no span."""
    spans, host, device = [], [], []
    aten = set()
    for on_device, name, start, end, corr, linked, thread, note in raw:
        if on_device:
            if not note and name != SPAN:
                device.append((start, end, name, linked))
        elif name == SPAN:
            spans.append((start, end, thread))
        else:
            if linked == 0 and name.startswith("aten::"):
                aten.add(corr)
            host.append((start, end, name, thread))
    if not spans:
        return None
    spans.sort()
    main = spans[0][2]
    lo, hi = spans[0][0], max(e for _, e, _ in spans)
    starts = [s for s, _, _ in spans]
    per_span = collections.defaultdict(list)
    port = other = 0
    by_name = collections.Counter()
    for start, end, name, linked in device:
        clipped = _clip([(start, end)], lo, hi)
        if not clipped:
            continue
        (s, e), = clipped
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < spans[i][1]:
            per_span[i].append((s, min(e, spans[i][1])))
        if name.startswith(("Memcpy", "Memset")) or linked in aten:
            other += e - s
        else:
            port += e - s
        by_name[name] += e - s
    busy = _union([(s, e) for s, e, _, _ in device])
    busy = _clip([tuple(b) for b in busy], lo, hi)
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if busy:
        gaps += [(busy[0][0] - lo, lo, busy[0][0]),
                 (hi - busy[-1][1], busy[-1][1], hi)]
    gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:top]
    host_main = sorted(h for h in host if h[3] == main)
    host_starts = [h[0] for h in host_main]
    idle = [[_doing(host_main, host_starts, spans, (a + b) // 2), g / 1e9]
            for g, a, b in gaps]
    return Digest(
        spans=[(s, e) for s, e, _ in spans],
        busy_in_span_s=[sum(e - s for s, e in _union(per_span[i])) / 1e9
                        for i in range(len(spans))],
        port_kernel_s=port / 1e9, other_device_s=other / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9, window_s=(hi - lo) / 1e9,
        breakdown={"device_ops": [[n, t / 1e9]
                                  for n, t in by_name.most_common(top)],
                   "idle_gaps": idle})


def _doing(host: list, starts: list, spans: list, t: int) -> str:
    """The innermost host operation of the main thread running at ``t``:
    of those that cover ``t``, the one that started last."""
    last = bisect.bisect_right(starts, t) - 1
    for i in range(last, max(-1, last - WALK), -1):
        if host[i][1] >= t:
            return host[i][2]
    inside = any(s <= t <= e for s, e, _ in spans)
    return f"{SPAN} (python)" if inside else "between requests"
