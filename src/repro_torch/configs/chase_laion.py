"""The paper's own workload config: LAION-shaped hybrid-query corpus.

§7.1 scaled down by default (full-scale values in comments); the card runs
the full scale with ``dataclasses.replace(bench_config(),
n_rows=1_000_000, n_queries=100)`` (``chip_smoke.py``)."""
import dataclasses

from ..core.physical import ProbeConfig
from ..core.schema import Metric


@dataclasses.dataclass(frozen=True)
class ChaseBenchConfig:
    n_rows: int = 100_000          # paper: 1_000_000
    n_queries: int = 32            # paper: 100
    dim: int = 512                 # paper: 512 (CLIP)
    n_modes: int = 256             # synthetic cluster structure
    num_categories: int = 8
    metric: Metric = Metric.INNER_PRODUCT
    nlist: int = 256               # IVF lists (≈ HNSW M=16/ef=48 regime)
    kmeans_iters: int = 10
    k_top: int = 50                # Q1/Q4 K
    k_category: int = 10           # Q5/Q6 K
    range_match_target: int = 120  # §7.1: radius tuned to ~120 matches
    selectivities: tuple = (1.0, 0.9, 0.7, 0.5, 0.3, 0.03)
    probe: ProbeConfig = ProbeConfig(max_probes=64, capacity=4096,
                                     stop_after_no_improve=6,
                                     out_range_stop=4, min_probes=8)
    seed: int = 0


def bench_config() -> ChaseBenchConfig:
    """The default (scaled) benchmark configuration."""
    return ChaseBenchConfig()


def smoke_bench_config() -> ChaseBenchConfig:
    """A small configuration for quick runs and tests."""
    return ChaseBenchConfig(n_rows=5000, n_queries=8, dim=64, n_modes=32,
                            nlist=32, kmeans_iters=3,
                            probe=ProbeConfig(max_probes=24, capacity=1024))
