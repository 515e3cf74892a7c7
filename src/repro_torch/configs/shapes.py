"""Assigned input-shape presets (the 4 LM shapes × 10 archs = 40 cells)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# smoke-scale counterparts (same kinds, CPU-sized)
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 64, 2),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 96, 1),
    "decode_32k": ShapeConfig("decode_32k", "decode", 64, 2),
    "long_500k": ShapeConfig("long_500k", "decode", 128, 1),
}
