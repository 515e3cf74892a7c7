"""quant.roofline_share: the quantized scan kernel's share of its
roofline, in percent: the least time of the traced requests' work, the
benchmark's own request bound (``chasebench/roofline.py``: FLOPs over the
fp32 peak, as the kernel widens the twin to fp32 and multiplies there, or
bytes over the HBM rate, whichever is larger), over the kernel's device
time in the device trace.

The kernel is found by its name among the trace's device operations:
``quant_topk_kernel`` (``quant_scan_topk_batch``), or the range tile with
the int8 row loader (``range_tile_kernel`` over ``Int8Rows``:
``quant_keys_batch``).  Its device time alone, so the idle time inside a
span is not counted.  Nothing where the trace holds neither kernel among
its longest operations, or on a card the peak table does not hold."""


def _is_scan(name: str) -> bool:
    return "quant_topk_kernel" in name or (
        "range_tile_kernel" in name and "Int8Rows" in name)


def read(ctx):
    t = ctx.trace
    if t is None or ctx.request_bound_s is None or not t.executes:
        return None
    kernel_s = sum(s for name, s in t.breakdown["device_ops"]
                   if _is_scan(name))
    if kernel_s <= 0:
        return None
    return 100.0 * ctx.request_bound_s * t.executes / kernel_s
