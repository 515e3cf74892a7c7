"""Deterministic synthetic data pipeline with a checkpointable cursor (the
port of ``src/repro/data/pipeline.py``).

A batch is a pure function of (seed, step): any host can regenerate any
shard of any step, so a restart needs no data-loader state beyond the
cursor integer inside the ``TrainState``.  The draws are the reference's,
made with numpy's ``default_rng`` in the same order, so tokens, labels and
embeddings are equal to the reference's, not merely close; only the last
step differs, the arrays become tensors on ``device``.  Shard-aware: a
host materialises only its slice of the global batch (``host_start``,
``host_count``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Synthetic-stream shape knobs (batch/sequence/vocab sizing)."""
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    vocab_size: int = 512
    input_mode: str = "tokens"
    d_model: int = 64              # embeddings mode


class SyntheticLM:
    """Markov-ish synthetic token stream (structured enough that the loss
    falls during a short training run)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # low-entropy bigram table => learnable structure
        self.bigram = rng.integers(0, cfg.vocab_size,
                                   size=(cfg.vocab_size,)).astype(np.int32)

    def host_batch_at(self, step: int, host_start: int = 0,
                      host_count: int | None = None) -> dict:
        """The batch for ``step`` (or a host's slice of it) as numpy arrays:
        int32 ``tokens`` / ``labels``, or fp32 ``embeds`` and ``labels``."""
        cfg = self.cfg
        count = host_count if host_count is not None else cfg.global_batch
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) % (2**63))
        # skip to the host slice deterministically
        starts = rng.integers(0, cfg.vocab_size,
                              size=(cfg.global_batch,)).astype(np.int32)
        starts = starts[host_start:host_start + count]
        toks = np.empty((count, cfg.seq_len), np.int32)
        toks[:, 0] = starts
        noise = rng.random((cfg.global_batch, cfg.seq_len))
        noise = noise[host_start:host_start + count]
        for t in range(1, cfg.seq_len):
            follow = self.bigram[toks[:, t - 1]]
            rand = ((toks[:, t - 1].astype(np.int64) * 7919 + t)
                    % cfg.vocab_size).astype(np.int32)
            toks[:, t] = np.where(noise[:, t] < 0.8, follow, rand)
        labels = np.roll(toks, -1, axis=1)
        if cfg.input_mode == "tokens":
            return {"tokens": toks, "labels": labels}
        embrng = np.random.default_rng(cfg.seed + 17)
        table = embrng.standard_normal(
            (cfg.vocab_size, cfg.d_model)).astype(np.float32)
        return {"embeds": table[toks], "labels": labels}

    def batch_at(self, step: int, host_start: int = 0,
                 host_count: int | None = None, device="cuda") -> dict:
        """:meth:`host_batch_at` as tensors on ``device``: the same (seed,
        step) always yields the same tokens / labels."""
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.host_batch_at(step, host_start,
                                               host_count).items()}

    def iterate(self, start_step: int = 0, device="cuda"):
        """Endless (step, batch) stream beginning at ``start_step``."""
        step = start_step
        while True:
            yield step, self.batch_at(step, device=device)
            step += 1
