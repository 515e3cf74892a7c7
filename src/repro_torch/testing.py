"""Parity helpers shared by the tests and ``chip_smoke.py``.

Two implementations of a scan never add up a dot product in the same
order, so results are compared under a tie rule instead of bit for bit.
:func:`assert_topk_close` holds top-k results:

* ``valid`` and the counters (``stats``) are exactly equal;
* ids are equal at each rank, except that a swap, or a different k-th
  member, is accepted only where the two rows' keys differ by at most
  ``tie_tol``;
* sims agree to ``atol``.

:func:`assert_range_close` holds range results (a best-first buffer of hits
and the count before truncation), with one more rule: a row whose sim lies
within ``tie_tol`` of the radius may be a hit on one side only.

:func:`ssd_backward_gap` is the one count the per-device dry-run may differ
from the reference's by.
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


def assert_range_close(actual: dict, expected: dict, *, radius, atol: float,
                       tie_tol: float, near=None, what: str = "range") -> float:
    """Hold one range result against another.

    ``actual`` and ``expected`` map ``ids`` (or a join's ``tid``), ``sim``,
    ``valid`` and ``count`` (and optionally ``stats`` and ``qid``) to arrays
    or tensors: buffers of shape (..., P), best hit first, and counts of
    shape (...,).  ``radius`` (raw metric value) broadcasts to the counts'
    shape; so does ``near``, the number of rows whose sim lies within
    ``tie_tol`` of the radius, counted by the caller over the whole corpus.

    * the counters, ``qid`` and the buffer shapes are exactly equal, empty
      slots hold id -1, and each side's buffer holds min(count, P) hits;
    * a hit on one side only is accepted when its sim lies within
      ``tie_tol`` of the radius (a boundary row), or when the other
      side's buffer is full and its sim lies within ``tie_tol`` of that
      buffer's last sim (a different last member);
    * the hits on both sides keep their order, except for swaps of hits
      whose sims differ by at most ``tie_tol``, and their sims agree to
      ``atol``;
    * the counts differ by at most the number of boundary rows seen, plus
      ``near`` where a buffer was truncated (its boundary rows fall past
      the end and cannot be seen); without ``near`` they must then agree.

    Raises AssertionError on a breach; returns the largest sim difference
    over the hits both sides hold."""
    key = "ids" if "ids" in actual else "tid"
    ids_a, ids_b = _rows(_np(actual[key])), _rows(_np(expected[key]))
    sim_a, sim_b = _rows(_np(actual["sim"])), _rows(_np(expected["sim"]))
    val_a, val_b = _rows(_np(actual["valid"])), _rows(_np(expected["valid"]))
    cnt_a = _np(actual["count"]).reshape(-1)
    cnt_b = _np(expected["count"]).reshape(-1)
    if ids_a.shape != ids_b.shape or cnt_a.shape != cnt_b.shape:
        raise AssertionError(f"{what}: shapes {ids_a.shape} {cnt_a.shape} != "
                             f"{ids_b.shape} {cnt_b.shape}")
    count_shape = _np(expected["count"]).shape
    rad = np.broadcast_to(np.asarray(_np(radius), np.float64),
                          count_shape).reshape(-1)
    near = (np.zeros(cnt_a.shape, np.int64) if near is None else
            np.broadcast_to(_np(near), count_shape).reshape(-1))
    if "stats" in actual and "stats" in expected:
        sa, sb = actual["stats"], expected["stats"]
        if set(sa) != set(sb):
            raise AssertionError(f"{what}: counters {sorted(sa)} != "
                                 f"{sorted(sb)}")
        for name in sa:
            np.testing.assert_array_equal(
                _np(sa[name]), _np(sb[name]), err_msg=f"{what}: {name}")
    if "qid" in actual and "qid" in expected:
        np.testing.assert_array_equal(_np(actual["qid"]),
                                      _np(expected["qid"]),
                                      err_msg=f"{what}: qid")
    cap = ids_a.shape[1]
    err = 0.0
    for r in range(ids_a.shape[0]):
        sides = []
        for ids, sims, val, cnt in ((ids_a, sim_a, val_a, cnt_a),
                                    (ids_b, sim_b, val_b, cnt_b)):
            v = val[r]
            if (ids[r][~v] != -1).any():
                raise AssertionError(f"{what}: row {r}: empty slot without "
                                     f"id -1")
            if int(v.sum()) != min(int(cnt[r]), cap) or not v[:v.sum()].all():
                raise AssertionError(
                    f"{what}: row {r}: {int(v.sum())} hits held for count "
                    f"{int(cnt[r])} and a buffer of {cap}")
            sides.append((ids[r][v], sims[r][v]))
        (ia, sa), (ib, sb) = sides
        by_a, by_b = dict(zip(ia.tolist(), sa)), dict(zip(ib.tolist(), sb))
        boundary = 0
        for mine, other, s_other in ((by_a, by_b, sb), (by_b, by_a, sa)):
            for i in mine.keys() - other.keys():
                s = float(mine[i])
                if abs(s - rad[r]) <= tie_tol:
                    boundary += 1
                elif not (s_other.size == cap
                          and abs(s - float(s_other[-1])) <= tie_tol):
                    raise AssertionError(
                        f"{what}: row {r}: id {i} (sim {s}) is a hit on one "
                        f"side only, neither at the radius {rad[r]} nor tied "
                        f"with a full buffer's last member")
        common = [i for i in ia.tolist() if i in by_b]
        if common:
            diff = np.abs(np.array([by_a[i] for i in common])
                          - np.array([by_b[i] for i in common]))
            err = max(err, float(diff.max()))
            if not err <= atol:
                raise AssertionError(f"{what}: sims differ by {err} > atol "
                                     f"{atol}")
            order_b = [i for i in ib.tolist() if i in by_a]
            for i, j in zip(common, order_b):
                if i != j and abs(float(by_a[i]) - float(by_a[j])) > tie_tol:
                    raise AssertionError(
                        f"{what}: row {r}: ids {i} and {j} swap places with "
                        f"sims more than tie_tol {tie_tol} apart")
        truncated = max(int(cnt_a[r]), int(cnt_b[r])) > cap
        allowed = boundary + (int(near[r]) if truncated else 0)
        if abs(int(cnt_a[r]) - int(cnt_b[r])) > allowed:
            raise AssertionError(
                f"{what}: row {r}: counts {int(cnt_a[r])} vs "
                f"{int(cnt_b[r])} differ by more than the {allowed} rows at "
                f"the radius")
    return err


def ssd_backward_gap(arch: str, shape: str, mesh: str = "tiny") -> int:
    """One device's share of the FLOPs the reference's SSM training step
    counts and the port's does not, at --smoke-config: per SSM layer four
    reductions of 2·B·S·H·16 FLOPs (the SSD's pairwise contractions with
    no contracted index, whose transposes the reference's backward
    contracts as dots and torch's autograd sums; ROADMAP queue 3, "Facts
    about the reference"), split as the step's batch and SSM heads are
    split over ``mesh``; 0 for any other cell."""
    from .configs import get_config, get_shape
    from .dist.sharding import entry_size
    from .launch.dryrun import _mesh_for
    from .launch.shardspec import rules_for
    cfg = get_config(arch, smoke=True)
    sh = get_shape(shape, smoke=True)
    if cfg.ssm is None or sh.kind != "train":
        return 0
    s = cfg.ssm
    assert s.d_state == s.head_dim == s.chunk == 16
    heads = s.expand * cfg.d_model // s.head_dim
    layers = sum(k == "ssm" for k in map(cfg.pattern_for_layer,
                                         range(cfg.num_layers)))
    m = _mesh_for(mesh)
    rules = rules_for(cfg, sh, m)
    ways = entry_size(m, rules["batch"]) * entry_size(m, rules["ff_heads"])
    whole = layers * 4 * 2 * sh.global_batch * sh.seq_len * heads * 16
    assert whole % ways == 0
    return whole // ways
