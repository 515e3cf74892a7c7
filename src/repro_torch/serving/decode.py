"""Serving steps: prefill, single-token decode (the dry-run's
``serve_step``) and a batched greedy / temperature generation loop (the
port of ``src/repro/serving/decode.py``).

Serving runs under ``torch.inference_mode()``.  Caches are updated in
place (``models.transformer``), so every ``prefill`` starts from a fresh
cache and ``generate`` twice on the same inputs gives the same tokens."""
from __future__ import annotations

import time

import torch

from ..models import decode_step, init_cache
from ..models.config import ModelConfig


def build_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens/embeds) -> (next_token_logits,
    cache): one new token against the cache."""

    def serve_step(params, cache, tokens=None, embeds=None):
        logits, cache = decode_step(params, cfg, cache, tokens=tokens,
                                    embeds=embeds)
        return logits[:, -1, :], cache

    return serve_step


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, tokens=None, embeds=None,
            max_seq: int | None = None):
    """Build a fresh cache by replaying the sequence through decode steps
    (the reference's cache-fidelity prefill, held against ``forward`` by
    the tests).  Returns (cache, logits (B, S, V))."""
    xs = tokens if tokens is not None else embeds
    b, s = xs.shape[:2]
    cache = init_cache(cfg, b, max_seq or s, device=xs.device)
    logits = []
    for t in range(s):
        if tokens is not None:
            lg, cache = decode_step(params, cfg, cache,
                                    tokens=tokens[:, t:t + 1])
        else:
            lg, cache = decode_step(params, cfg, cache,
                                    embeds=embeds[:, t:t + 1])
        logits.append(lg[:, 0])
    return cache, torch.stack(logits, dim=1)


def _clock(device: torch.device) -> float:
    """Seconds on the host's clock once ``device`` has finished its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.inference_mode()
def generate(params, cfg: ModelConfig, prompt_tokens: torch.Tensor,
             num_steps: int, max_seq: int | None = None,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             timings: dict | None = None) -> torch.Tensor:
    """Greedy (``argmax``, the first maximum) or temperature generation
    (tokens mode).  Temperature draws come from ``generator`` (default: one
    seeded with 0 on the prompts' device).  Returns (B, num_steps) int32:
    the tokens decoded after the prompt's own next token, as the
    reference's loop emits them.  A ``timings`` dict receives
    ``prefill_s`` (the prompt's replay and its next token) and
    ``decode_s`` (the ``num_steps`` steps after it), the device
    synchronised at each end."""
    b, s = prompt_tokens.shape
    cap = max_seq or (s + num_steps)
    dev = prompt_tokens.device
    if timings is not None:
        t0 = _clock(dev)
    cache, logits = prefill(params, cfg, tokens=prompt_tokens, max_seq=cap)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    if timings is not None:
        t1 = _clock(dev)
        timings["prefill_s"] = t1 - t0
    if temperature > 0 and generator is None:
        generator = torch.Generator(prompt_tokens.device).manual_seed(0)
    out = []
    for _ in range(num_steps):
        lg, cache = decode_step(params, cfg, cache, tokens=tok[:, None])
        lg = lg[:, -1, :]
        if temperature > 0:
            probs = torch.softmax(lg.to(torch.float32) / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(lg, dim=-1)
        tok = nxt.to(torch.int32)
        out.append(tok)
    if timings is not None:
        timings["decode_s"] = _clock(dev) - t1
    if not out:
        return torch.zeros((b, 0), dtype=torch.int32,
                           device=prompt_tokens.device)
    return torch.stack(out, dim=1)
