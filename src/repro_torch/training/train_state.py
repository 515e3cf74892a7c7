"""The train state: params + optimizer moments + data-pipeline cursor (the
port of ``src/repro/training/train_state.py``).

One dataclass that flows through the step, the checkpointer and a resume
as one object.  ``rng`` is the uint32[2] key data of the reference's
``jax.random.key(seed)`` (``[0, seed mod 2**32]`` with JAX's 64-bit mode
off, as the reference runs), held as a tensor and stored as the
reference stores a key (``.rng__prngkey``).  No step draws from it; it
rides along, as in the reference."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.transformer import tree_map


def prng_key(seed: int, device=None) -> torch.Tensor:
    """The key data of the reference's ``jax.random.key(seed)`` with JAX's
    64-bit mode off: uint32[2] ``[0, seed mod 2**32]``."""
    return torch.tensor([0, seed % 2**32], dtype=torch.uint32,
                        device=device)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: dict
    step: torch.Tensor                 # global step (int32, 0-d)
    data_cursor: torch.Tensor          # data-pipeline position (int32, 0-d)
    rng: torch.Tensor = dataclasses.field(metadata={"prngkey": True})

    @classmethod
    def create(cls, params, opt, rng):
        """A state at step 0 (counters on ``rng``'s device, a tensor each,
        as every later state holds them)."""
        def zero():
            return torch.zeros((), dtype=torch.int32, device=rng.device)

        return cls(params=params, opt=opt, step=zero(), data_cursor=zero(),
                   rng=rng)

    def to(self, device) -> "TrainState":
        """Every leaf moved to ``device`` (a leaf already there is kept)."""
        def move(x):
            return x.to(device) if isinstance(x, torch.Tensor) else x

        return TrainState(params=tree_map(move, self.params),
                          opt=tree_map(move, self.opt),
                          step=move(self.step),
                          data_cursor=move(self.data_cursor),
                          rng=move(self.rng))
