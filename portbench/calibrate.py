"""The readings a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> [--seeds 12] [--control 3] [--faults 3] [--witness 2]
                                   [--first-seed N] [--out FILE]

For each of ``--seeds`` seeds the program's compared numbers (set-up, a
one-unit window, the check); for ``--control`` seeds the control's (the
reference in float8 e4m3 in the program's place); ``--faults`` seeds of
each fault of the cell's kind (``portbench/faults.py``, planted in the
program as the tests plant it); ``--witness`` seeds of the program run at
``precision: fp32`` (a second witness). Prints one JSON line a run and writes them all to
``--out``. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench import faults
    from portbench.harness import HERE, load_json, run_cell

    manifest = load_json(ROOT / "BENCHMARK.json")
    traffic = next(w["traffic"] for w in manifest["workloads"] if w["name"] == args.workload)
    kind = load_json(HERE / "workloads" / f"{traffic}.json")["kind"]
    plan = [("program", "program", None, {}, args.seeds), ("control", "control", None, {}, args.control)]
    plan += [(fault.__name__, "program", fault, {}, args.faults) for fault in faults.BY_KIND[kind]]
    plan.append(("program_fp32", "program", None, {"cfg": {"precision": "fp32"}}, args.witness))
    rows = []
    seed = args.first_seed
    for label, mode, fault, overrides, n in plan:
        for _ in range(n):
            seed += 7919
            patches = faults.Patches()
            if fault is not None:
                fault(patches)
            try:
                line = run_cell(args.workload, seed, 0.0, False, overrides=overrides, mode=mode, stream=io.StringIO())
            finally:
                patches.undo()
            row = {"mode": label, "seed": seed, "correct": line["correct"], **line.get("notes", {})}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    for mode in sorted({r["mode"] for r in rows}):
        sel = [r["numbers"] for r in rows if r["mode"] == mode]
        summary = {k: {"min": min(s[k] for s in sel), "max": max(s[k] for s in sel)} for k in sel[0]}
        print(f"summary {mode} ({len(sel)} runs): {json.dumps(summary)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
