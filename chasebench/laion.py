"""The LAION-shaped synthetic corpus, frozen inside the benchmark.

The same laws as the port's ``data/laion.py`` (paper §7.1, Table 2), drawn
on the device from one seeded ``torch.Generator`` in a few large calls, so
that the yardstick does not move when the program's own generator does:

* vectors: a mixture on the unit sphere around ``modes`` unit modes, the
  noise's norm ``spread`` times the mode's (0.35 for rows, 0.15 for
  queries);
* columns: ``height``, ``width`` uniform in [64, 2048); ``nsfw`` 0 / 1 / 2
  with 0.9 / 0.07 / 0.03; ``similarity`` Beta(2, 4); ``price``
  LogNormal(3.5, 1.0); ``capture_date`` in [0, 3650); ``calorie_level``,
  ``cuisine`` in [0, categories); ``rating`` in [0, 5); ``release_year`` in
  [1980, 2026).

One seed gives the same tensors on one device type and torch version.  A
deployment's structure (its modes and which mode each row belongs to) is
drawn from a seed of its own, so that runs with different seeds hold the
same clusters, their rows' noise, columns and queries drawn anew.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# rows drawn per call: bounds the temporaries at 2 x 512 MB for D = 512
CHUNK = 262_144


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named stream of one run's seed
    (the data and the traffic draw from separate streams)."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(
        1, dtype=np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def unit_modes(gen: torch.Generator, n_modes: int, dim: int) -> torch.Tensor:
    """(n_modes, dim) fp32 unit vectors."""
    m = torch.randn(n_modes, dim, generator=gen, device=gen.device)
    return m / torch.linalg.vector_norm(m, dim=1, keepdim=True)


def mixture(gen: torch.Generator, modes: torch.Tensor, n: int,
            spread: float, which: torch.Tensor | None = None) -> torch.Tensor:
    """(n, dim) fp32 unit vectors, row i around ``modes[which[i]]`` (modes
    drawn uniformly from ``gen`` where ``which`` is not given), its noise
    drawn from ``gen``."""
    dim = modes.shape[1]
    out = torch.empty(n, dim, device=modes.device)
    sigma = spread / math.sqrt(dim)
    if which is None:
        which = torch.randint(modes.shape[0], (n,), generator=gen,
                              device=gen.device)
    for start in range(0, n, CHUNK):
        rows = min(CHUNK, n - start)
        x = torch.randn(rows, dim, generator=gen, device=gen.device)
        x.mul_(sigma).add_(modes[which[start:start + rows]])
        x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))
        out[start:start + rows] = x
    return out


def columns(gen: torch.Generator, n: int, categories: int) -> dict:
    """The laion table's scalar columns, int32 and fp32, on the device."""
    dev = gen.device

    def ints(lo: int, hi: int) -> torch.Tensor:
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    u = torch.rand(n, generator=gen, device=dev)
    nsfw = (u >= 0.9).to(torch.int32) + (u >= 0.97).to(torch.int32)
    # Beta(2, 4) = X / (X + Y) with X ~ Gamma(2), Y ~ Gamma(4), each a sum
    # of unit exponentials
    expo = -torch.log1p(-torch.rand(6, n, generator=gen, device=dev))
    x, y = expo[:2].sum(0), expo[2:].sum(0)
    price = torch.exp(3.5 + torch.randn(n, generator=gen, device=dev))
    return {
        "sample_id": torch.arange(n, dtype=torch.int32, device=dev),
        "height": ints(64, 2048),
        "width": ints(64, 2048),
        "nsfw": nsfw,
        "similarity": x / (x + y),
        "price": price,
        "capture_date": ints(0, 3650),
        "calorie_level": ints(0, categories),
        "cuisine": ints(0, categories),
        "rating": ints(0, 5),
        "release_year": ints(1980, 2026),
    }
