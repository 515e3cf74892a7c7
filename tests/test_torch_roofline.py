"""The port's roofline tooling (``repro_torch.roofline``) against the
reference's (``repro.roofline``), on the CPU.

* ``roofline_terms`` equals the reference's for the same ``HWSpec`` fields
  (the H100 SXM's figures under the reference's field names), and its
  dtype-aware compute term is each dtype's FLOPs over that dtype's peak.
* The counter's FLOPs equal the reference's ``hlo_analyzer.analyze`` of
  the compiled HLO for the smoke qwen2, moonshot and mamba2 forwards and
  train steps (B = 2, S = 64), with one stated exception: the reference's
  mamba2 step counts 4 products per SSM layer that the port computes as a
  multiply and a sum (see :func:`_ssd_backward_reductions`).
* Eager counting sees every loop iteration (the reference's trip-count
  test), the kernel wrappers report their launches' work and nothing of
  their plain versions, the port's collectives record their bytes (0 at
  one device), and live memory follows autograd's saved tensors.
* The ``report.py`` tables equal the reference's apart from the HBM
  wording (and "GFLOPs/dev" for "HLO GFLOPs/dev": the port has no HLO).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init
from repro.roofline import report as ref_report
from repro.roofline.analysis import roofline_terms as ref_terms
from repro.roofline.hlo_analyzer import analyze as ref_analyze
from repro.roofline.hw import HWSpec as RefHWSpec
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import TrainState as RefTrainState
from repro.training import TrainStepConfig as RefTrainStepConfig
from repro.training import adamw_init as ref_adamw_init
from repro.training import build_train_step as ref_build
from repro_torch import configs
from repro_torch.core.expr import distance_values
from repro_torch.core.schema import Metric
from repro_torch.dist.sharding import DistSpec, resolve_mesh
from repro_torch.kernels import distance, quant, range_scan, scan_topk
from repro_torch.models import forward, init_params
from repro_torch.roofline import (H100_NVL, H100_PCIE, H100_SXM, analyze,
                                  bound_ms, roofline_terms, spec_for)
from repro_torch.roofline import report as port_report
from repro_torch.roofline.op_counter import (OpCounter, Work, counted,
                                             report)
from repro_torch.training import (AdamWConfig, TrainState, TrainStepConfig,
                                  adamw_init, build_train_step)
from repro_torch.training.step import compressed_psum
from repro_torch.training.train_state import prng_key

B, S = 2, 64


def _ref_hw(hw) -> RefHWSpec:
    return RefHWSpec(name=hw.name, peak_flops_bf16=hw.peak_flops_bf16,
                     hbm_bw=hw.hbm_bw, ici_link_bw=hw.link_bw,
                     hbm_bytes=hw.hbm_bytes)


TERMS = ("compute_s", "memory_s", "collective_s", "hlo_flops_total",
         "hlo_bytes_total", "collective_bytes_per_device", "model_flops",
         "dominant", "step_time_lower_bound_s", "useful_flops_fraction",
         "roofline_fraction")


@pytest.mark.parametrize("hw", [H100_SXM, H100_NVL, H100_PCIE],
                         ids=lambda h: h.name)
@pytest.mark.parametrize("case", [
    ({"flops": 1e12, "bytes accessed": 1e11}, {"all-reduce": 5e9}, 256,
     2e14),
    ({"flops": 3e14, "bytes accessed": 2e11}, {}, 1, 1e14),
    ({"flops": 5e13, "bytes accessed": 4e12}, {"all-gather": 1e9,
                                               "all-reduce": 2e9}, 8, 4e13),
])
def test_roofline_terms_match_reference(hw, case):
    cost, coll, chips, mf = case
    got = roofline_terms(cost, coll, chips, mf, hw)
    want = ref_terms(cost, coll, chips, mf, _ref_hw(hw))
    for name in TERMS:
        assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                   rel=1e-12), name


def test_compute_term_is_dtype_aware():
    by = {"bf16": 9.1e13, "fp32": 2.3e13, "fp64": 1e12}
    t = roofline_terms({"flops": sum(by.values()), "bytes accessed": 1e9,
                        "flops_by_dtype": by}, {}, 1, 0.0)
    assert t.compute_s == pytest.approx(9.1e13 / 989e12 + 2.3e13 / 67e12
                                        + 1e12 / 67e12, rel=1e-12)
    assert t.dominant == "compute"
    assert spec_for("NVIDIA H100 80GB HBM3") is H100_SXM
    assert spec_for("NVIDIA H100 NVL") is H100_NVL
    assert spec_for("NVIDIA H100 PCIe") is H100_PCIE


# ---------------------------------------------------------------------------
# the counter against the reference's HLO analyzer
# ---------------------------------------------------------------------------

def _ref_flops(arch: str, kind: str) -> float:
    cfg = ref_configs.get_config(arch, smoke=True)
    p = ref_init(jax.random.key(0), cfg)
    toks = jnp.zeros((B, S), jnp.int32)
    if kind == "forward":
        fn = jax.jit(lambda p, t: ref_forward(p, cfg, tokens=t)[0])
        args = (p, toks)
    else:
        oc = RefAdamWConfig()
        fn = jax.jit(ref_build(cfg, oc, RefTrainStepConfig()))
        args = (RefTrainState.create(p, ref_adamw_init(oc, p),
                                     jax.random.key(0)),
                {"tokens": toks, "labels": toks})
    return ref_analyze(fn.lower(*args).compile().as_text()).flops


def _port_cost(arch: str, kind: str):
    cfg = configs.get_config(arch, smoke=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.zeros((B, S), dtype=torch.int32)
    if kind == "forward":
        with torch.no_grad():
            return analyze(lambda p, t: forward(p, cfg, tokens=t)[0], p,
                           toks)
    oc = AdamWConfig()
    state = TrainState.create(p, adamw_init(oc, p), prng_key(0))
    return analyze(build_train_step(cfg, oc, TrainStepConfig()), state,
                   {"tokens": toks, "labels": toks})


def _ssd_backward_reductions(arch: str) -> float:
    """FLOPs the reference's mamba2 step counts and the port's does not.

    The SSD's three- and four-operand einsums (``y_intra``, ``state_c``,
    ``y_inter``) contract pairwise; a pair with no contracted dimension
    (an outer or elementwise product) is a multiply in both forwards, but
    its transpose in the reference's backward is a ``dot_general`` that
    contracts the dimension the forward broadcast, where torch's autograd
    of ``einsum``'s multiply is a multiply and a sum: per SSM layer four
    such reductions, each of 2·B·S·H·16 FLOPs at the smoke config (H = 8
    heads; d_state = head_dim = chunk = 16: the contracted lengths)."""
    cfg = configs.get_config(arch, smoke=True)
    s = cfg.ssm
    assert s.d_state == s.head_dim == s.chunk == 16
    heads = s.expand * cfg.d_model // s.head_dim
    layers = sum(k == "ssm" for k in map(cfg.pattern_for_layer,
                                         range(cfg.num_layers)))
    return layers * 4 * 2 * B * S * heads * 16


@pytest.mark.parametrize("kind", ["forward", "step"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "moonshot-v1-16b-a3b",
                                  "mamba2-370m"])
def test_counter_flops_match_reference_hlo(arch, kind):
    cost = _port_cost(arch, kind)
    want = _ref_flops(arch, kind)
    gap = _ssd_backward_reductions(arch) if (arch, kind) == (
        "mamba2-370m", "step") else 0.0
    assert cost.flops_total + gap == want
    # the smoke configs are fp32 end to end, and so are their products
    assert cost.flops["fp32"] == cost.flops_total
    if gap:
        assert gap == 524_288


def test_bf16_products_count_as_bf16():
    cfg = dataclasses.replace(configs.get_config("qwen2-1.5b", smoke=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    p = init_params(torch.Generator().manual_seed(0), cfg, "meta")
    toks = torch.zeros((B, S), dtype=torch.int32, device="meta")
    with torch.no_grad():
        cost = analyze(lambda p, t: forward(p, cfg, tokens=t)[0], p, toks)
    # the projections run in bf16; attention's scores and values in fp32
    assert cost.flops["bf16"] > 0 and cost.flops["fp32"] > 0
    assert cost.flops_total == 54_525_952       # the fp32 model's count


def test_loop_of_seven_products_counts_seven():
    """The reference's trip-count test: a while loop of 7 products and 7
    all-reduces.  Eager counting sees each iteration."""
    x = torch.ones(128, 256)
    w = torch.ones(256, 256)

    def body(x, w):
        for _ in range(7):
            x = x @ w
            (x,), _err = compressed_psum([[x], [x]],
                                         [[torch.zeros_like(x)]] * 2)
        return x

    cost = analyze(body, x, w)
    assert cost.flops_total == 7 * 2 * 128 * 256 * 256
    assert cost.collective_bytes["all-reduce"] == 7 * 128 * 256 * 4
    assert cost.per_op["aten.mm.default"]["calls"] == 7
    text = report(cost)
    assert text.startswith("flops=")
    assert "all-reduce" in text and "aten.mm.default" in text


# ---------------------------------------------------------------------------
# kernel wrappers, collectives, memory
# ---------------------------------------------------------------------------

def _kernel_calls():
    g = torch.Generator().manual_seed(0)
    n, d, qn, k = 2000, 32, 6, 7
    corpus = torch.randn(n, d, generator=g)
    qs = torch.randn(qn, d, generator=g)
    mask2 = (torch.rand(qn, n, generator=g) < 0.5).to(torch.int8)
    mask1 = mask2[0].contiguous()
    qvalid = torch.tensor([1, 1, 0, 1, 0, 1], dtype=torch.int8)
    rk = torch.full((qn,), -0.5)
    twin = (corpus * 20).round().clamp(-127, 127).to(torch.int8)
    scales = torch.full((n,), 0.05)
    rows = torch.randint(0, n + 5, (qn, 40), generator=g, dtype=torch.int32)
    m = Metric.INNER_PRODUCT
    return [
        (scan_topk.scan_topk, (corpus, qs[0], mask1, k, m)),
        (scan_topk.scan_topk_batch, (corpus, qs, mask2, qvalid, k, m)),
        (scan_topk.scan_topk_batch, (corpus, qs, mask1, None, k, m)),
        (range_scan.range_scan, (corpus, qs[0], rk[:1], None, m)),
        (range_scan.range_scan_batch, (corpus, qs, rk, mask2, qvalid, m)),
        (quant.quant_scan_topk_batch, (twin, scales, qs, mask2, qvalid, 14,
                                       m)),
        (quant.quant_scan_topk_batch, (twin.to(torch.bfloat16),
                                       torch.ones(n), qs, None, None, 14,
                                       m)),
        (quant.quant_keys_batch, (twin, scales, qs, mask1, qvalid, m)),
        (quant.replay_keys, (corpus, qs, rows, m)),
        (distance.pairwise_keys, (qs, corpus, m)),
        (range_scan.range_topk_batch, (corpus, qs, rk, mask2, qvalid, m,
                                       16)),
        (range_scan.range_topk_batch, (corpus, qs, rk, mask1, None, m,
                                       3000)),
    ]


WORK = {"scan_topk": scan_topk.scan_topk_work,
        "scan_topk_batch": scan_topk.scan_topk_batch_work,
        "range_scan": range_scan.range_scan_work,
        "range_scan_batch": range_scan.range_scan_batch_work,
        "range_topk_batch": range_scan.range_topk_batch_work,
        "quant_scan_topk_batch": quant.quant_scan_topk_batch_work,
        "quant_keys_batch": quant.quant_keys_batch_work,
        "replay_keys": quant.replay_keys_work,
        "pairwise_keys": distance.pairwise_keys_work}


@pytest.mark.parametrize("i", range(12))
def test_kernel_wrapper_reports_its_work_only(i):
    fn, args = _kernel_calls()[i]
    out = fn(*args)
    cost = analyze(fn, *args)
    w = WORK[fn.__name__](*args)
    assert cost.kernels == {fn.__name__: {"launches": 1,
                                          "ops": float(w.ops),
                                          "bytes": float(w.nbytes)}}
    # the plain version's ops are not counted: one event, the launch
    assert [e[0] for e in cost.events] == [f"kernel {fn.__name__}"]
    assert cost.flops == {"bf16": 0.0, "fp32": float(w.ops), "fp64": 0.0}
    assert cost.bytes == w.nbytes
    # counting changes no answer, and a wrapper outside a counter counts
    # nothing
    again = fn(*args)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.name)
def test_plain_distance_counts_the_kernels_formula(metric):
    """The plain scan's rowwise distance is one op of 2·D operations a row
    (fp32), as a kernel launch of the same scan counts; inside a kernel
    wrapper it counts nothing beside the launch."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2000, 32, generator=g)
    q = torch.randn(3, 1, 32, generator=g)
    want = distance_values(metric, x, q)
    cost = analyze(distance_values, metric, x, q)
    ops = 2.0 * 3 * 2000 * 32
    assert cost.flops == {"bf16": 0.0, "fp32": ops, "fp64": 0.0}
    assert cost.kernels == {}
    assert cost.per_op == {"distance_values": {
        "calls": 1, "flops": ops,
        "bytes": float((x.numel() + q.numel() + 3 * 2000) * 4)}}
    assert [e[0] for e in cost.events] == ["distance_values"]
    assert torch.equal(distance_values(metric, x, q), want)

    @counted(lambda x, q: Work(7, 11))
    def wrapper(x, q):
        return distance_values(metric, x, q)

    cost = analyze(wrapper, x, q)
    assert [e[0] for e in cost.events] == ["kernel wrapper"]
    assert cost.flops_total == 7 and cost.bytes == 11


def test_work_formulas_read_the_kernel_table_bounds():
    """The bound column of the kernel table (PERF.md) at N = 1M, D = 512,
    K = 50, 100 live queries in bucket 128, read from the formulas on
    ``meta`` tensors (only shapes are read; the valid lanes on the host)."""
    n, d, k, bucket = 1_000_000, 512, 50, 128

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def lanes(b, live):
        return (torch.arange(b) < live).to(torch.int8)

    corpus = meta(n, d)
    i8, bf = meta(n, d, dtype=torch.int8), meta(n, d, dtype=torch.bfloat16)
    mask = meta(bucket, n, dtype=torch.int8)
    ms = lambda w: round(bound_ms(w)[0], 3)            # noqa: E731
    by = lambda w: bound_ms(w)[1]                      # noqa: E731
    qv = lanes(bucket, 100)
    w = scan_topk.scan_topk_batch_work(corpus, meta(bucket, d), mask, qv, k)
    assert (ms(w), by(w)) == (1.528, "operations")
    assert w.ops == 2 * 100 * n * d
    for b, live, want in ((32, 30, 0.621), (8, 8, 0.614), (1, 1, 0.612)):
        w = scan_topk.scan_topk_batch_work(corpus, meta(b, d),
                                           meta(b, n, dtype=torch.int8),
                                           lanes(b, live), k)
        assert (ms(w), by(w)) == (want, "bytes")
    w = scan_topk.scan_topk_work(corpus, meta(d), meta(n, dtype=torch.int8),
                                 k)
    assert (ms(w), by(w)) == (0.612, "bytes")
    w = range_scan.range_scan_batch_work(corpus, meta(bucket, d),
                                         meta(bucket), mask, qv)
    assert (ms(w), by(w)) == (1.528, "operations")
    w = range_scan.range_scan_batch_work(corpus, meta(64, d), meta(64),
                                         meta(64, n, dtype=torch.int8),
                                         lanes(64, 64))
    assert (ms(w), by(w)) == (0.978, "operations")
    w = range_scan.range_scan_work(corpus, meta(d), meta(1),
                                   meta(n, dtype=torch.int8))
    assert (ms(w), by(w)) == (0.613, "bytes")
    for twin, want in ((i8, 0.154), (bf, 0.306)):
        w = quant.quant_scan_topk_batch_work(twin, meta(n), meta(1, d),
                                             meta(1, n, dtype=torch.int8),
                                             lanes(1, 1), 2 * k)
        assert (ms(w), by(w)) == (want, "bytes")
    w = distance.pairwise_keys_work(meta(100, d), corpus)
    assert (ms(w), by(w)) == (1.528, "operations")
    w = distance.pairwise_keys_work(meta(8, d), corpus)
    assert (ms(w), by(w)) == (0.621, "bytes")


@pytest.mark.parametrize("shards", [1, 2])
def test_collectives_record_bytes_only_across_devices(shards):
    from repro_torch.dist.collectives import distributed_topk_batch
    g = torch.Generator().manual_seed(0)
    corpus = torch.randn(400, 16, generator=g)
    qs = torch.randn(3, 16, generator=g)
    mesh = resolve_mesh(DistSpec((shards,), ("data",)), "cpu")
    rows = 400 // shards
    sh_corpus = [corpus[s * rows:(s + 1) * rows] for s in range(shards)]
    sh_ids = [torch.arange(s * rows, (s + 1) * rows, dtype=torch.int32)
              for s in range(shards)]
    fn = distributed_topk_batch(mesh, Metric.INNER_PRODUCT, 5)
    cost = analyze(fn, sh_corpus, sh_ids, qs, [None] * shards)
    gathered = 3 * 5 * shards * (4 + 4) if shards > 1 else 0
    assert cost.collective_bytes["all-gather"] == gathered
    grads = [[torch.ones(10)] for _ in range(shards)]
    errs = [[torch.zeros(10)] for _ in range(shards)]
    cost = analyze(compressed_psum, grads, errs)
    assert cost.collective_bytes["all-reduce"] == (40 if shards > 1 else 0)
    assert cost.collective_total == cost.collective_bytes["all-reduce"]


def test_live_memory_follows_saved_tensors():
    n = 1 << 16
    x = torch.ones(n, requires_grad=True)

    def f(x):
        y = x.exp()           # saved by exp's backward, alive after f
        return (y * 2).sum()

    with OpCounter() as c:
        c.arguments(x)
        loss = f(x)
        held = c._live_bytes
        loss.backward()
        x.grad = None
        del loss
        freed = c._live_bytes
    # the saved exp output (4n bytes) outlives f until the backward ran
    assert held >= c.cost.argument_bytes + 4 * n
    assert freed == c.cost.argument_bytes
    with torch.no_grad():
        cost = analyze(f, x)
    assert cost.peak_bytes - cost.argument_bytes <= 2 * 4 * n + 64
    assert cost.output_bytes == 4 and cost.alias_bytes == 0
    # an argument returned as it is counts as aliased
    cost = analyze(lambda t: t, x)
    assert cost.alias_bytes == cost.output_bytes == 4 * n
    # the bytes a call must move: arguments read once, new outputs written
    # once; an argument updated in place is not written again, and the
    # temporaries (the exp's 4n bytes) are left out
    w = torch.ones(n // 2)

    def step(x, w):
        w.add_(1)
        return w, x.exp().sum(), x * 3

    with torch.no_grad():
        cost = analyze(step, x, w)
    assert cost.argument_bytes == 4 * n + 2 * n
    assert cost.moved_bytes == cost.argument_bytes + 4 + 4 * n
    assert cost.bytes > cost.moved_bytes


def test_lowered_reads_as_jax_lowered():
    from repro_torch.roofline import lower
    lw = lower(lambda a, b: a @ b, torch.ones(4, 8), torch.ones(8, 3))
    assert lw.cost_analysis() == {"flops": 2 * 4 * 8 * 3,
                                  "bytes accessed": (32 + 24 + 12) * 4}
    assert lw.compile().cost_analysis() == lw.cost_analysis()
    lines = lw.as_text().splitlines()
    assert lines[0].startswith("# 1 ops and launches")
    assert lines[1].startswith("aten.mm.default float32[4, 8] float32[8, 3]")


# ---------------------------------------------------------------------------
# report tables
# ---------------------------------------------------------------------------

def _records(mesh: str) -> list:
    def ok(arch, shape, kind, dom, coll, frac, useful):
        return {"arch": arch, "shape": shape, "mesh": mesh, "kind": kind,
                "status": "ok", "compile_s": 3.0,
                "memory": {"argument_bytes": 3e9, "temp_bytes": 2e9,
                           "output_bytes": 1e9, "alias_bytes": 5e8},
                "peak_bytes": 5.5e9, "fits_hbm": True,
                "cost": {"flops_per_device": 1.2e13},
                "collective_bytes": coll,
                "roofline": {"compute_s": 0.2, "memory_s": 0.3,
                             "collective_s": 0.1 if dom != "collective"
                             else 0.5, "dominant": dom,
                             "model_flops": 2e15,
                             "useful_flops_fraction": useful,
                             "roofline_fraction": frac}}
    return [
        ok("qwen2-1.5b", "train_4k", "train", "memory", {"all-reduce": 1e9},
           0.4, 0.6),
        ok("qwen2-1.5b", "decode_32k", "decode", "memory", {}, 0.01, 0.9),
        ok("gemma2-27b", "train_4k", "train", "collective",
           {"all-gather": 2e9, "all-reduce": 1e9}, 0.2, 0.8),
        ok("gemma3-12b", "train_4k", "train", "compute",
           {"all-reduce": 3e9}, 0.7, 0.9),
        ok("mamba2-370m", "prefill_32k", "prefill", "memory", {}, 0.3, 0.9),
        {"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": mesh,
         "kind": "decode", "status": "skipped"},
        {"arch": "grok-1-314b", "shape": "train_4k", "mesh": mesh,
         "kind": "train", "status": "error"},
    ]


def test_report_tables_match_reference():
    recs = _records("single")
    want = ref_report.dryrun_table(recs, "single")
    want = want.replace("fits 16GB", "fits 80GB").replace(
        "HLO GFLOPs/dev", "GFLOPs/dev")
    assert port_report.dryrun_table(recs, "single") == want
    assert port_report.roofline_table(recs, "single") == \
        ref_report.roofline_table(recs, "single")
    assert [port_report.advice(r) for r in recs if r["status"] == "ok"] == \
        [ref_report.advice(r) for r in recs if r["status"] == "ok"]
    assert port_report.pick_hillclimb(recs, "single") == \
        ref_report.pick_hillclimb(recs)
    # the port's default mesh is the dry-run's "one"
    ones = _records("one")
    assert port_report.roofline_table(ones) == \
        ref_report.roofline_table(recs, "single").replace("| single", "| one")
    assert port_report.pick_hillclimb(ones) == ref_report.pick_hillclimb(recs)


def test_work_is_a_pair():
    w = Work(3, 4)
    assert bound_ms(w) == (4 / H100_SXM.hbm_bw * 1e3, "bytes")
    assert dataclasses.is_dataclass(H100_SXM)
    assert np.isclose(bound_ms(Work(67e9, 1))[0], 1.0)
