"""Architecture registry of the port: ``--arch <id>`` resolution for every
launcher, and the paper's own workload config, :mod:`.chase_laion`.

The ten model configs and the shape presets are the reference's, field for
field (``tests/test_torch_models.py`` holds them equal)."""
from __future__ import annotations

from . import (chameleon_34b, chase_laion, gemma2_27b, gemma3_12b,
               grok1_314b, h2o_danube3_4b, mamba2_370m, moonshot_v1_16b_a3b,
               musicgen_medium, qwen2_1_5b, zamba2_1_2b)
from .shapes import SHAPES, SMOKE_SHAPES, ShapeConfig

_MODULES = {
    m.ARCH_ID: m
    for m in (gemma3_12b, h2o_danube3_4b, gemma2_27b, qwen2_1_5b,
              mamba2_370m, zamba2_1_2b, grok1_314b, moonshot_v1_16b_a3b,
              musicgen_medium, chameleon_34b)
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    m = _MODULES[arch]
    return m.smoke_config() if smoke else m.full_config()


def get_shape(name: str, smoke: bool = False) -> ShapeConfig:
    table = SMOKE_SHAPES if smoke else SHAPES
    return table[name]


def cells(include_skipped: bool = True):
    """All 40 (arch, shape) cells; marks long_500k skips per DESIGN.md."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            skipped = (shape == "long_500k"
                       and not cfg.supports_long_context)
            if include_skipped or not skipped:
                out.append((arch, shape, skipped))
    return out


__all__ = ["ARCH_IDS", "get_config", "get_shape", "cells", "SHAPES",
           "SMOKE_SHAPES", "ShapeConfig", "chase_laion"]
