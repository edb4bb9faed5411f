"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, and that every file a name points to is there."""

import json
import re

import pytest

from pb_helpers import CELLS, MANIFEST, ROOT, kind_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|_dim$|_rank$|experts_per_tok)")


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert MANIFEST["paths"] == ["portbench"] and MANIFEST["command"] == ["python3", "portbench/run.py"]


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keys_names_and_text(section):
    entries = MANIFEST[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        allowed = ENTRY_KEYS[section] | ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert ENTRY_KEYS[section] <= set(e) <= allowed, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key], (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for cell in e.get("workloads", []):
            assert cell in CELLS


def test_configs_files_and_reduced():
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_cells_have_their_files_and_metrics():
    e2e, layers = MANIFEST["end_to_end"], MANIFEST["per_layer"]
    assert {m["name"] for m in e2e} == {"train_rays_per_s", "render_rays_per_s", "extract_s", "setup_s"}
    assert next(m for m in e2e if m["name"] == "setup_s")["bound"] <= 0.25
    for m in e2e:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1
        assert (ROOT / "portbench" / "workloads" / f"{w['traffic']}.json").exists()
        assert (ROOT / "portbench" / "kinds" / f"{kind_of(w['name'])}.py").exists()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()
        reported = [m["name"] for m in e2e if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in layers)
    for m in layers:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {x["name"] for x in e2e}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:  # each cell it lists reports the metric it moves
            moved = next(x for x in e2e if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])
    by_layer = {}
    for m in layers:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_check_budget_fits_with_24_cells():
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
