"""Parity helper shared by the tests and ``chip_smoke.py`` (numpy only).

Two implementations of a top-k never add up a dot product in the same
order, so results are compared under a tie rule instead of bit for bit:

* ``valid`` and the counters (``stats``) are exactly equal;
* ids are equal at each rank, except that a swap, or a different k-th
  member, is accepted only where the two rows' keys differ by at most
  ``tie_tol``;
* sims agree to ``atol``.
"""
from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):            # a torch tensor, on any device
        x = x.detach().cpu()
    return np.asarray(x)


def _rows(x: np.ndarray) -> np.ndarray:
    return x[None] if x.ndim == 1 else x.reshape(-1, x.shape[-1])


def assert_topk_close(actual: dict, expected: dict, *, atol: float,
                      tie_tol: float, what: str = "top-k") -> float:
    """Hold one top-k result against another.

    ``actual`` and ``expected`` map ``ids``, ``sim`` and ``valid`` (and
    optionally ``stats``, a dict of counters) to arrays or tensors of the
    same shape, (k,) or (..., k).  Raises AssertionError on a breach of the
    rules above; returns the largest sim difference over valid entries."""
    ids_a, ids_b = _rows(_np(actual["ids"])), _rows(_np(expected["ids"]))
    sim_a, sim_b = _rows(_np(actual["sim"])), _rows(_np(expected["sim"]))
    val_a, val_b = _rows(_np(actual["valid"])), _rows(_np(expected["valid"]))
    if ids_a.shape != ids_b.shape:
        raise AssertionError(f"{what}: shapes {ids_a.shape} != {ids_b.shape}")
    np.testing.assert_array_equal(val_a, val_b, err_msg=f"{what}: valid")
    if "stats" in actual and "stats" in expected:
        sa, sb = actual["stats"], expected["stats"]
        if set(sa) != set(sb):
            raise AssertionError(f"{what}: counters {sorted(sa)} != "
                                 f"{sorted(sb)}")
        for name in sa:
            np.testing.assert_array_equal(
                _np(sa[name]), _np(sb[name]), err_msg=f"{what}: {name}")
    err = float(np.max(np.abs(sim_a[val_a] - sim_b[val_a]), initial=0.0))
    if not err <= atol:
        raise AssertionError(f"{what}: sims differ by {err} > atol {atol}")
    for r in range(ids_a.shape[0]):
        v = val_a[r]
        if (ids_a[r][~v] != -1).any() or (ids_b[r][~v] != -1).any():
            raise AssertionError(f"{what}: row {r}: empty slot without id -1")
        ia, ib = ids_a[r][v], ids_b[r][v]
        sa, sb = sim_a[r][v], sim_b[r][v]
        diff = ia != ib
        if not diff.any():
            continue
        gap = float(np.max(np.abs(sa[diff] - sb[diff])))
        if gap > tie_tol:
            j = int(np.argmax(diff))
            raise AssertionError(
                f"{what}: row {r} rank {j}: id {ia[j]} vs {ib[j]} with keys "
                f"{gap} apart > tie_tol {tie_tol}")
        for mine, other, s_mine, s_other in ((ia, ib, sa, sb),
                                             (ib, ia, sb, sa)):
            for i in np.setdiff1d(mine, other):
                s = float(s_mine[mine == i][0])
                if abs(s - float(s_other[-1])) > tie_tol:
                    raise AssertionError(
                        f"{what}: row {r}: id {i} (sim {s}) is a member on "
                        f"one side only, not tied with the k-th "
                        f"({float(s_other[-1])})")
    return err
