"""Stand-ins for every model input (the port of
``src/repro/launch/inputs.py``): tensors on ``device="meta"`` with the
shapes and dtypes of the reference's ``ShapeDtypeStruct`` s, so nothing is
allocated.  ``[audio]`` / ``[vlm]`` archs take precomputed frame / patch
embeddings (the modality frontend is a stub)."""
from __future__ import annotations

import torch

from ..configs.shapes import ShapeConfig
from ..models.config import ModelConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "tokens":
        return {"tokens": _spec((b, s), torch.int32),
                "labels": _spec((b, s), torch.int32)}
    return {"embeds": _spec((b, s, cfg.d_model), cfg.cdtype()),
            "labels": _spec((b, s), torch.int32)}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "tokens":
        return {"tokens": _spec((b, s), torch.int32)}
    return {"embeds": _spec((b, s, cfg.d_model), cfg.cdtype())}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    if cfg.input_mode == "tokens":
        return {"tokens": _spec((b, 1), torch.int32)}
    return {"embeds": _spec((b, 1, cfg.d_model), cfg.cdtype())}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
