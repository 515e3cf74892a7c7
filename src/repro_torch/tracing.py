"""Spans and counters of the execute path.

A span names one stage of a request: the front door
(``repro_torch.execute``), bind stacking (``repro_torch.bind``), the
executor (``repro_torch.executor``), a structured predicate
(``repro_torch.predicate``), a hand-written kernel's launch
(``repro_torch.kernel.<wrapper>``), the plain-torch step after a kernel
(``repro_torch.stage2``), and on a quantized twin's scan
(``kernels/quant.py``) the twin's kernel with its candidate selection
(``repro_torch.quant.scan``) and the fp32 replay with its re-rank
(``repro_torch.quant.replay``).  Tracing is off by default, and then
:func:`span` reads one flag and hands back a shared context that does
nothing.  After :func:`enable` each span

* enters a profiler range named ``name`` (the C++ ``RecordFunction`` that
  ``torch.profiler.record_function`` wraps, entered directly through
  ``torch._C._profiler._RecordFunctionFast`` at a twentieth of the
  wrapper's host cost where torch has it), so that it sits in a profiler's
  host timeline on the clock the device activity is aligned to (and in a
  Chrome export of that trace);
* adds its calls, host seconds and self seconds (host seconds less those
  of the spans it encloses) to a table kept per name, bounded whatever the
  number of spans; each thread keeps its own stack of open spans;
* given a CUDA ``device``, records a pair of timing events on that
  device's current stream, folded into the table as device seconds (the
  stream's time from the first event to the second) once complete.

Counters are always on, at the cost of an integer add: ``uploads`` counts
host-to-device copies of the execute path, ``syncs`` the points where it
waits for a card's stream (each blocking upload, each host read of a
device value, the IVF probe loop's active check), ``range_overflows`` the
queries of a batched range compaction that had more hits than its buffer
and were recomputed on the dense path (``kernels/ops.py``
``fused_range_topk_batch``).  On a quantized twin (``kernels/quant.py``):
``quant_replayed`` the (query, row) slots replayed in fp32 (from the
shapes, pad lanes and empty slots included), ``quant_band_rows`` the rows
of a quantized range list's slack band (its maybe rows, summed over the
queries), ``quant_fallbacks`` the quantized range calls that ran the fp32
range kernel instead.

:func:`snapshot` returns the table and the counters; call it after the
card's work is done (it waits for pending events).  Typical use::

    from repro_torch import tracing
    tracing.enable()
    before = tracing.snapshot()
    ...                                  # statements executed
    torch.cuda.synchronize()
    after = tracing.snapshot()
"""
from __future__ import annotations

import threading
import time

import torch

EXECUTE = "repro_torch.execute"
BIND = "repro_torch.bind"
EXECUTOR = "repro_torch.executor"
PREDICATE = "repro_torch.predicate"
STAGE2 = "repro_torch.stage2"
KERNEL = "repro_torch.kernel."
QUANT_SCAN = "repro_torch.quant.scan"
QUANT_REPLAY = "repro_torch.quant.replay"
COUNTERS = ("uploads", "syncs", "range_overflows", "quant_replayed",
            "quant_band_rows", "quant_fallbacks")

# pending event pairs folded in (the complete ones) once this many wait
_FOLD_AT = 64
# the profiler range a span enters
_range = torch._C._profiler._RecordFunctionFast

_enabled = False
_lock = threading.Lock()
_local = threading.local()
# name -> [calls, host ns, self ns, device calls, device ms]
_table: dict = {}
_pending: list = []      # (row, start event, end event)
_spare: list = []        # timing events to reuse
_streams: dict = {}      # (device index, raw stream) -> torch.cuda.Stream
counters = dict.fromkeys(COUNTERS, 0)


class _Null:
    """The span of disabled tracing: enters and leaves doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


def enable() -> None:
    """Turn spans on (counters are always on)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn spans off; the table keeps what it holds."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    """Whether spans are on."""
    return _enabled


def span(name: str, device=None):
    """A context manager timing one stage under ``name``; with a CUDA
    ``device``, also the stream's time across it.  A shared no-op while
    tracing is off."""
    if not _enabled:
        return NULL
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        counters[name] += n


def count_upload(value, device) -> None:
    """Count one upload, and the wait on the stream that a blocking copy
    makes, where ``value`` is on the host and ``device`` is not the CPU."""
    if _device_type(device) == "cpu" or (isinstance(value, torch.Tensor)
                                         and value.device.type != "cpu"):
        return
    with _lock:
        counters["uploads"] += 1
        counters["syncs"] += 1


def _device_type(device) -> str:
    if isinstance(device, torch.device):
        return device.type
    return torch.device(device).type


def _stream(device):
    """The current stream of a CUDA device, found by its raw handle
    (``torch.cuda.current_stream`` takes microseconds of Python)."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(index)
    return stream


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _row(name: str) -> list:
    row = _table.get(name)
    if row is None:
        row = _table[name] = [0, 0, 0, 0, 0.0]
    return row


class _Span:
    __slots__ = ("name", "stream", "record", "start", "inner", "events")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = (_stream(device) if device is not None
                       and _device_type(device) == "cuda" else None)

    def __enter__(self):
        self.record = _range(self.name)
        self.record.__enter__()
        if self.stream is not None:
            self.events = (_event(), _event())
            self.events[0].record(self.stream)
        self.inner = 0
        _stack().append(self)
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        took = time.perf_counter_ns() - self.start
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].inner += took
        if self.stream is not None:
            self.events[1].record(self.stream)
        with _lock:
            row = _row(self.name)
            row[0] += 1
            row[1] += took
            row[2] += took - self.inner
            if self.stream is not None:
                _pending.append((row, *self.events))
                if len(_pending) >= _FOLD_AT:
                    _fold(wait=False)
        self.record.__exit__(*exc)
        return False


def _event():
    try:
        return _spare.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _fold(wait: bool) -> None:
    """Fold event pairs into their rows, oldest first: with ``wait`` every
    pair, waiting for each; else up to the first one not complete.  The
    caller holds the lock."""
    done = 0
    for row, start, end in _pending:
        if wait:
            end.synchronize()
        elif not end.query():
            break
        row[3] += 1
        row[4] += start.elapsed_time(end)
        _spare.extend((start, end))
        done += 1
    del _pending[:done]


def snapshot() -> dict:
    """``{"spans": {name: {"calls", "host_s", "self_s", "device_calls",
    "device_s"}}, "counters": {...}}``, all since the process started
    (spans only while enabled); waits for pending device events."""
    with _lock:
        _fold(wait=True)
        spans = {name: {"calls": r[0], "host_s": r[1] / 1e9,
                        "self_s": r[2] / 1e9, "device_calls": r[3],
                        "device_s": r[4] / 1e3}
                 for name, r in _table.items()}
    return {"spans": spans, "counters": dict(counters)}


def reset() -> None:
    """Empty the table and zero the counters."""
    with _lock:
        _fold(wait=True)
        _table.clear()
        for name in counters:
            counters[name] = 0
