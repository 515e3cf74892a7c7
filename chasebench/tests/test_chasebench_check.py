"""The check that decides ``correct``: a sound run passes it, and the
control (the reference at TF32 in the program's place) and the program
broken underneath its entry each fail it, in every cell, at a size a test
run holds (rows cut, the vectors' width of 512 kept)."""
import pytest
import torch

from conftest import IVF, SINGLE, run_small

LISTS = ["laion1m-flat-q1-b100", IVF, "laion1m-flat-q2-b100"]
LIST_IDS = ["laion1m-flat-q1-b100", IVF["name"], "laion1m-flat-q2-b100"]
CELLS = LISTS + [SINGLE]
IDS = LIST_IDS + ["single"]


def failing(result):
    return [n for n, c in result["checks"].items()
            if (c["value"] < c["limit"] if n == "recall"
                else c["value"] > c["limit"])]


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_sound_run_is_correct(bench, cell):
    result = run_small(bench, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_control_at_tf32_is_not_correct(bench, cell):
    result = run_small(bench, cell, control=True)
    assert not result["correct"]
    assert "sim_err" in failing(result)


def _break(monkeypatch, fault):
    """Break ``Statement.execute``'s answers where they are produced."""
    from repro_torch.api import database
    real = database.Statement.execute
    last = {}

    def broken(self, binds=None, hints=None):
        out = real(self, binds, hints)
        data = out.data
        if fault == "stale":
            fresh = {k: v.clone() for k, v in data.items()
                     if isinstance(v, torch.Tensor)}
            data.update(last.get("answer", {}))
            last["answer"] = fresh
        elif fault == "half":
            half = data["valid"].shape[0] // 2
            data["valid"][half:] = False
            if "count" in data:
                data["count"][half:] = 0
        elif fault == "altered":
            data["ids"][..., 0] = (data["ids"][..., 0] + 1) % 20000
        return out

    monkeypatch.setattr(database.Statement, "execute", broken)


@pytest.mark.parametrize("fault", ["stale", "altered"])
@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_broken_answers_are_not_correct(bench, monkeypatch, cell, fault):
    _break(monkeypatch, fault)
    result = run_small(bench, cell)
    assert not result["correct"], (fault, result["checks"])


@pytest.mark.parametrize("cell", LISTS, ids=LIST_IDS)
def test_half_the_list_left_out_is_not_correct(bench, monkeypatch, cell):
    _break(monkeypatch, "half")
    result = run_small(bench, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["laion1m-flat-q1-b100"])
def test_failed_requests_are_not_correct(bench, monkeypatch, cell):
    from repro_torch.api import database

    def raises(self, binds=None, hints=None):
        raise RuntimeError("planted")

    monkeypatch.setattr(database.Statement, "execute", raises)
    # the warm-up runs the same entry: a program that cannot answer fails
    with pytest.raises(RuntimeError, match="planted"):
        run_small(bench, cell)
