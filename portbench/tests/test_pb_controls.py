"""``correct`` has to come out false for the control and for each fault a
cell can have. The control is the reference in float8 e4m3 put in the
program's place; the faults break the timed path underneath the harness:
the faults of ``portbench/faults.py``, planted in the program.

On the CPU at a tiny size (the program's plain versions), and, marked
``card``, at each cell's own size on the card (``pytest portbench/tests -m
card`` there)."""

import io

import pytest

from pb_helpers import CELLS, SEED, kind_of, tiny
from portbench import faults
from portbench.harness import run_cell


CASES = [(cell, f) for cell in CELLS for f in faults.BY_KIND[kind_of(cell)]]
IDS = [f"{c}-{f.__name__}" for c, f in CASES]


def _run(cell, device, mode="program", seed=SEED, seconds=0.3):
    over = tiny(cell) if device == "cpu" else None
    return run_cell(cell, seed, seconds, False, device=device, overrides=over, mode=mode, stream=io.StringIO())


def _worse(bad: dict, good: dict) -> bool:
    return any(bad[k]["value"] > bad[k]["limit"] and bad[k]["value"] > 3 * good[k]["value"] for k in bad)


@pytest.mark.parametrize("cell,fault", CASES, ids=IDS)
def test_fault_is_not_correct_cpu(cell, fault, monkeypatch):
    sound = _run(cell, "cpu")["checks"]
    fault(monkeypatch.setattr)
    line = _run(cell, "cpu")
    assert not line["correct"] and _worse(line["checks"], sound), (line["checks"], sound)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_cpu(cell):
    sound = _run(cell, "cpu")["checks"]
    line = _run(cell, "cpu", mode="control")
    assert not line["correct"] and _worse(line["checks"], sound)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_three_seeds_card(cell, cuda_device):
    for seed in (SEED + 1, SEED + 2, SEED + 3):
        assert _run(cell, "cuda", seed=seed, seconds=0.0)["correct"]
        assert not _run(cell, "cuda", mode="control", seed=seed, seconds=0.0)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", CASES, ids=IDS)
def test_fault_is_not_correct_card(cell, fault, cuda_device, monkeypatch):
    fault(monkeypatch.setattr)
    assert not _run(cell, "cuda", seconds=0.0)["correct"]
