"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything a cell is comes from files found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``portbench/configs/``) and
its traffic mix (``portbench/workloads/<traffic>.json``, whose ``kind``
picks the module in ``portbench/kinds/`` that runs it); its limits are in
``portbench/limits/<cell>.json``; each per-layer metric is read by
``portbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nerfjax")


def boot_s() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start_boot_s() -> float:
    """When this process started, in seconds since boot (10 ms ticks)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return IMPORTED_AT


IMPORTED_AT = boot_s()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or nerfjax."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """Everything one run knows, handed to the kind's module and to each
    per-layer metric's reader."""

    def __init__(self, root: Path, cell: str, seed: int, seconds: float, trace: bool, device: str,
                 overrides: dict | None = None, mode: str = "program"):
        self.root, self.cell, self.seed, self.seconds, self.traced = root, cell, int(seed), seconds, trace
        self.mode = mode  # "program", or "control": the fp8 reference in the program's place
        self.manifest = load_json(root / "BENCHMARK.json")
        entry = next((w for w in self.manifest["workloads"] if w["name"] == cell), None)
        if entry is None:
            raise SystemExit(f"no workload named {cell!r} in BENCHMARK.json")
        self.entry = entry
        conf = next(c for c in self.manifest["configs"] if c["name"] == entry["config"])
        self.cfg = load_json(root / conf["file"])
        self.traffic = load_json(HERE / "workloads" / f"{entry['traffic']}.json")
        limits = HERE / "limits" / f"{cell}.json"
        self.limits = load_json(limits)["limits"] if limits.exists() else {}
        for key, value in (overrides or {}).items():
            getattr(self, key).update(value)
        self.kind = load_module(HERE / "kinds" / f"{self.traffic['kind']}.py", f"portbench_kind_{self.traffic['kind']}")
        self.device_name = device
        self.tmp = Path(os.environ.get("TMPDIR") or root / ".portbench_cache")
        self.tmp.mkdir(parents=True, exist_ok=True)
        from portbench.trace import NoSpans, Spans

        self.spans = Spans() if trace else NoSpans()
        self.marks: list[tuple[str, float]] = [("start", process_start_boot_s()), ("interpreter", IMPORTED_AT)]
        self.units: dict = {}
        self.e2e: dict = {}
        self.extra: dict = {}
        self.checks: list[tuple[str, float, float]] = []
        self.attempted = self.failed = 0
        self.dtrace = None
        self.outputs = None

    def mark(self, name: str) -> None:
        self.marks.append((name, boot_s()))

    def setup_split(self) -> dict:
        return {name: self.marks[i][1] - self.marks[i - 1][1] for i, (name, _) in enumerate(self.marks) if i}


def _device(run: Run, chips: int):
    import torch

    if run.device_name == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            raise SystemExit(2)
        torch.zeros(1, device="cuda")
        return torch.device("cuda", 0)
    return torch.device(run.device_name)


def units_by_fifth(t0: float, ends: list) -> list:
    """Units a second in each fifth of the window (how steady a run was)."""
    span = ends[-1] - t0
    counts = [0] * 5
    for e in ends:
        counts[min(4, int(5 * (e - t0) / span))] += 1
    return [c / (span / 5) for c in counts]


def _card_limits() -> str:
    """The card's name and power limit (a card set below 700 W runs slower)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def _number(x: float):
    return x if math.isfinite(x) else str(x)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", root: Path = ROOT,
             overrides: dict | None = None, mode: str = "program", stream=None) -> dict:
    """Run one cell once and return its result line (a dict); prints the
    compared numbers to stderr. ``overrides`` ({"cfg": {...}, "traffic":
    {...}, "limits": {...}}) and ``device="cpu"`` serve the tests."""
    import torch

    import nerfjax_torch  # noqa: F401  the program under test

    imported = boot_s()
    run = Run(root, cell, seed, seconds, trace, device, overrides, mode)
    run.marks.append(("imports", imported))
    run.device = _device(run, int(run.entry.get("chips", 1)))
    run.mark("device")
    kind = run.kind
    kind.setup(run)
    run.setup_s = boot_s() - run.marks[0][1]
    from portbench.trace import device_trace

    window = float(run.traffic.get("trace_seconds", seconds)) if trace and run.device.type == "cuda" else seconds
    with device_trace(trace) as held:
        kind.window(run, window)
    run.dtrace = held.trace
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    t_check = boot_s()
    kind.check(run)
    run.units["check_s"] = boot_s() - t_check
    failed_checks = [name for name, value, limit in run.checks if not value <= limit]
    correct = bool(run.checks) and not failed_checks and run.failed == 0

    metrics = {}
    wanted = [m for m in run.manifest["per_layer" if trace else "end_to_end"]
              if "workloads" not in m or cell in m["workloads"]]
    for m in wanted:
        if trace:
            value = load_module(HERE / "metrics" / f"{m['name']}.py", f"portbench_metric_{m['name']}").read(run)
        elif m["name"] == "setup_s":
            value = run.setup_s
        else:
            value = run.e2e.get(m["name"])
            if value is None:
                raise RuntimeError(f"the {run.traffic['kind']} kind gives no {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": _number(float(value)), "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": int(run.attempted), "failed": int(run.failed), "metrics": metrics,
            "device": dev}
    if trace and run.dtrace is not None:
        dev["busy_s"], dev["window_s"] = run.dtrace.busy_s(), run.dtrace.window_s
        line["breakdown"] = {"device_ops": run.dtrace.top_ops(), "idle_gaps": run.dtrace.idle_gaps(run.spans)}
    if "unit_ends" in run.extra:
        run.extra.setdefault("notes", {})["units_by_fifth"] = units_by_fifth(*run.extra["unit_ends"])
    if "notes" in run.extra:
        line["notes"] = run.extra["notes"]
    line["checks"] = {name: {"value": _number(value), "limit": limit} for name, value, limit in run.checks}
    err = stream or sys.stderr
    if trace and run.device.type == "cuda":
        print("portbench: card " + _card_limits(), file=err)
    print("portbench: setup_split_s " + json.dumps(run.setup_split()), file=err)
    print("portbench: units " + json.dumps(run.units), file=err)
    if failed_checks:
        print(f"portbench: NOT correct: {', '.join(failed_checks)} over the limit", file=err)
    if run.failed:
        print(f"portbench: NOT correct: {run.failed} of {run.attempted} units failed", file=err)
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=err)
    del run
    gc.collect()
    return line
