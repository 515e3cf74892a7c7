"""The trace digest on hand-made profiler events: spans, the port's
kernels against ``aten::`` ones and copies, busy and idle time, the
breakdown."""
from chasebench import trace


def ev(device, name, start, end, corr=0, linked=0, thread=1, note=False):
    return (device, name, start, end, corr, linked, thread, note)


def test_digest_splits_device_work_by_launcher():
    raw = [
        ev(False, trace.SPAN, 0, 900, corr=1, note=True),
        ev(False, trace.SPAN, 1200, 2000, corr=2, note=True),
        ev(False, "aten::sort", 100, 300, corr=3),
        ev(False, "cudaLaunchKernel", 110, 120, corr=90, linked=3),
        # the runtime's and the profiler's own events, their ids colliding
        # with the operation's
        ev(False, "cudaDeviceSynchronize", 950, 960, corr=3, linked=0),
        ev(False, "Buffer Flush", 970, 980, corr=3, linked=0),
        ev(True, trace.SPAN, 100, 900, note=True),   # the span on the card
        ev(True, "scan_topk_batch_kernel", 200, 500, linked=1),
        ev(True, "void at::native::sort", 500, 700, linked=3),
        ev(True, "Memcpy HtoD (Pageable -> Device)", 150, 200, linked=0),
        ev(True, "select_kernel", 1300, 1500, linked=0),
    ]
    d = trace.digest(iter(raw))
    assert d.executes == 2 and d.window_s == 2000 / 1e9
    assert d.port_kernel_s == (300 + 200) / 1e9
    assert d.other_device_s == (200 + 50) / 1e9
    assert d.busy_in_span_s == [550 / 1e9, 200 / 1e9]
    assert d.busy_s == 750 / 1e9
    names = [n for n, _ in d.breakdown["device_ops"]]
    assert names[0] == "scan_topk_batch_kernel"
    gaps = d.breakdown["idle_gaps"]
    assert gaps[0] == ["between requests", 600 / 1e9]
    assert len(d.breakdown["device_ops"]) <= 10 and len(gaps) <= 10


def test_digest_names_the_host_operation_under_a_gap():
    raw = [
        ev(False, trace.SPAN, 0, 1000, corr=1, note=True),
        ev(False, "aten::nonzero", 400, 900, corr=2),
        ev(True, "k", 0, 300, linked=2),
        ev(True, "k", 950, 1000, linked=2),
    ]
    d = trace.digest(iter(raw))
    assert d.breakdown["idle_gaps"][0] == ["aten::nonzero", 650 / 1e9]


def test_digest_without_spans_is_nothing():
    assert trace.digest(iter([ev(True, "k", 0, 10)])) is None
