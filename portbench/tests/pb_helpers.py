"""What the benchmark's tests share: the manifest, each cell's kind, and
the sizes at which a cell runs on the CPU in a few seconds (its kind's
``TINY``)."""

import json
from pathlib import Path

from portbench.harness import kind_module

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2**31 + 987_654_321  # more than 32 signed bits hold, as a run's seed may


def kind_of(cell: str) -> str:
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    return json.loads((ROOT / "portbench" / "workloads" / f"{entry['traffic']}.json").read_text())["kind"]


def tiny(cell: str) -> dict:
    return json.loads(json.dumps(kind_module(kind_of(cell)).TINY))
