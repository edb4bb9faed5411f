"""Every cell end to end at a tiny size on the CPU (the program's plain
versions): the result line's shape, and a control that reads worse than the
program on the cell's compared numbers."""

import io
import json
import math

import pytest

from pb_helpers import CELLS, MANIFEST, SEED, tiny
from portbench.harness import run_cell

TOP = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace=False, mode="program", seed=SEED):
    return run_cell(cell, seed, 0.3, trace, device="cpu", overrides=tiny(cell), mode=mode, stream=io.StringIO())


@pytest.mark.parametrize("cell", CELLS)
def test_line_shape(cell):
    line = _run(cell)
    assert list(line)[: len(TOP)] == TOP and list(line)[-1] == "checks"
    json.dumps(line)
    assert line["attempted"] >= 1 and line["failed"] == 0
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == set(e2e)
    for name, m in line["metrics"].items():
        assert m["unit"] == e2e[name]["unit"] and m["value"] > 0
    for name, c in line["checks"].items():
        assert math.isfinite(c["value"]) and set(c) == {"value", "limit"}, name
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_reads_only_per_layer_metrics(cell):
    line = _run(cell, trace=True)
    names = {m["name"] for m in MANIFEST["per_layer"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= names  # a CPU run has no device trace: those readers return nothing
    assert all(m["unit"] == next(x["unit"] for x in MANIFEST["per_layer"] if x["name"] == n)
               for n, m in line["metrics"].items())




def test_same_seed_same_inputs():
    import numpy as np

    from portbench import traffic

    scene = json.loads((__import__("pb_helpers").ROOT / "portbench/workloads/ball_rays.json").read_text())["scene"]
    a, b = traffic.ball_rays(SEED, 1000, scene), traffic.ball_rays(SEED, 1000, scene)
    c = traffic.ball_rays(SEED + 1, 1000, scene)
    assert all(np.array_equal(a[k], b[k]) for k in a) and not np.array_equal(a["rays_o"], c["rays_o"])
