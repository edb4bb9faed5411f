"""``correct`` has to come out false for the control and for each fault a
cell can have. The control is the reference in float8 e4m3 put in the
program's place; the faults break the timed path underneath the harness:
each kind's ``FAULTS``, planted in the program.

On the CPU at a tiny size (the program's plain versions), and, marked
``card``, at each cell's own size on the card (``pytest portbench/tests -m
card`` there)."""

import io

import pytest

from pb_helpers import CELLS, SEED, kind_of, tiny
from portbench.harness import kind_module, run_cell


CASES = [(cell, f) for cell in CELLS for f in kind_module(kind_of(cell)).FAULTS]
IDS = [f"{c}-{f.__name__}" for c, f in CASES]


FIRST_CASES = ["ngp_dropin.train-unchanged", "ngp_dropin.train-half_batch", "nerf_vanilla.train-unchanged",
               "nerf_vanilla.train-half_batch", "ngp_dropin.render-altered_frame",
               "ngp_dropin.extract-altered_volume", "ngp_dropin.extract-dropped_voxels"]
FIRST_TINY = [
    ("train", {"cfg": {"nerf_type": "small", "hash_n_levels": 8, "batch_size": 64, "N_samples": 8, "N_importance": 16,
                       "train_rays": 4096, "hidden_dim": 32},
               "traffic": {"warmup_steps": 4}}),
    ("render", {"cfg": {"nerf_type": "small", "hash_n_levels": 8, "N_samples": 8, "N_importance": 16},
                "traffic": {"frame": [24, 24], "chunk_rays": 128}}),
    ("extract", {"cfg": {"nerf_type": "small", "hash_n_levels": 8}, "traffic": {"resolution": 128}}),
]


def test_the_first_cells_keep_their_seven_cases():
    """The cells of the first three kinds have the fault cases they had when one list in
    ``faults.py`` held them, in order; cells of later kinds add theirs."""
    first = {c.rsplit("-", 1)[0] for c in FIRST_CASES}
    assert [i for (c, _), i in zip(CASES, IDS) if c in first] == FIRST_CASES


@pytest.mark.parametrize("kind,sizes", FIRST_TINY, ids=[k for k, _ in FIRST_TINY])
def test_the_first_kinds_keep_their_cpu_sizes(kind, sizes):
    assert kind_module(kind).TINY == sizes


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
