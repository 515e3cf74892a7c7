"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points run on the card unless the caller asks for the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\s|\.|$)",
                       re.MULTILINE)


def _modules() -> list[str]:
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_jax_or_reference():
    mods = _modules()
    assert {"repro_torch.kernels.scan_topk",
            "repro_torch.kernels.distance"} <= set(mods)
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_have_no_jax_or_reference_imports():
    offenders = [f"{p.relative_to(SRC)}: {m.group(0).strip()}"
                 for p in sorted(PORT.rglob("*.py"))
                 for m in FORBIDDEN.finditer(p.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("from repro.core import x")
    assert not FORBIDDEN.search("from repro_torch.core import x")


def test_entry_points_default_to_cuda():
    """Without ``device=`` the catalog lands on the card; on a machine
    without one that raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default placement works")
    from repro_torch.data import catalog_from_numpy, make_laion_catalog

    with pytest.raises((RuntimeError, AssertionError)):
        make_laion_catalog(n_rows=64, n_queries=2, dim=8, n_modes=2)
    tables = {"t": {"columns": {"v": np.zeros((4, 8), np.float32)},
                    "kinds": {"v": ("vector", 8, "ip")}}}
    with pytest.raises((RuntimeError, AssertionError)):
        catalog_from_numpy(tables, {"t": "t"})


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.core.schema import Metric
    from repro_torch.kernels.ops import (fused_range_scan,
                                         fused_range_scan_batch,
                                         fused_range_topk_batch,
                                         fused_scan_topk, fused_scan_topk_batch)

    corpus = torch.zeros((32, 8), device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        fused_scan_topk(corpus, torch.zeros(8, device="meta"), 3, None,
                        Metric.L2)
    with pytest.raises(ValueError, match="runs on cuda"):
        fused_scan_topk_batch(corpus, torch.zeros((2, 8), device="meta"), 3,
                              None, Metric.L2)
    with pytest.raises(ValueError, match="range_scan runs on cuda"):
        fused_range_scan(corpus, torch.zeros(8, device="meta"), 0.5, None,
                         Metric.L2)
    for batch, name in ((fused_range_scan_batch, "range_scan_batch"),
                        (lambda *a: fused_range_topk_batch(*a, capacity=4),
                         "range_topk_batch")):
        with pytest.raises(ValueError, match=f"{name} runs on cuda"):
            batch(corpus, torch.zeros((2, 8), device="meta"), 0.5, None,
                  Metric.L2)
    from repro_torch.kernels import quant

    q8 = torch.zeros((32, 8), dtype=torch.int8, device="meta")
    scales = torch.ones((32, 1), device="meta")
    queries = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="quant_scan_topk_batch runs on cuda"):
        quant.quant_scan_topk_batch(q8, scales, queries, None, None, 6,
                                    Metric.L2)
    with pytest.raises(ValueError, match="quant_keys_batch runs on cuda"):
        quant.quant_keys_batch(q8.to(torch.bfloat16), scales, queries, None,
                               None, Metric.L2)
    with pytest.raises(ValueError, match="replay_keys runs on cuda"):
        quant.replay_keys(corpus, queries,
                          torch.zeros((2, 5), dtype=torch.int32,
                                      device="meta"), Metric.L2)
    from repro_torch.kernels import distance, pairwise_keys

    for fn in (distance.pairwise_keys, pairwise_keys):
        with pytest.raises(ValueError, match="pairwise_keys runs on cuda"):
            fn(queries, corpus, Metric.COSINE)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quant_without_the_kernels_raises(mode):
    """The quantized lowering IS the kernel path: asking for it without
    ``use_pallas`` raises instead of quietly running fp32."""
    from repro_torch.core import EngineOptions, compile_query
    from repro_torch.data import make_laion_catalog

    cat = make_laion_catalog(n_rows=64, n_queries=2, dim=8, n_modes=2,
                             device="cpu")
    sql = ("SELECT sample_id FROM products "
           "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 3")
    with pytest.raises(ValueError, match="use_pallas"):
        compile_query(sql, cat, EngineOptions(engine="brute", quant=mode,
                                              use_pallas=False))
    assert cat.quantized_for("products", "embedding", mode) is None
