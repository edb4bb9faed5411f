"""Nothing the harness and the reference import is jax, jaxlib, flax or
nerfjax (top-level names compared whole: the port's name begins with the
JAX package's), and the reference imports nothing of nerfjax_torch."""

import ast
import json
import subprocess
import sys

from pb_helpers import ROOT, SEED, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "nerfjax"}
PB = ROOT / "portbench"


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


PRELUDE = f"import json, sys; sys.path.insert(0, {str(ROOT)!r})\n"
TOPS = "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n"


def test_a_run_of_every_kind_loads_no_jax():
    runs = "".join(
        f"run_cell({cell!r}, {SEED}, 0.2, True, device='cpu', overrides={TINY[kind]!r}, stream=io.StringIO())\n"
        for cell, kind in (("ngp_dropin.train", "train"), ("nerf_vanilla.train", "train"),
                           ("ngp_dropin.render", "render"), ("ngp_dropin.extract", "extract")))
    tops = _loaded(PRELUDE + "import io\nfrom portbench.harness import run_cell, load_module\n" + runs
                   + "import portbench.calibrate, portbench.work, portbench.trace\n" + TOPS)
    assert "nerfjax_torch" in tops and not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = sorted(p.stem for p in (PB / "reference").glob("*.py") if p.stem != "__init__")
    tops = _loaded(PRELUDE + "".join(f"import portbench.reference.{m}\n" for m in mods) + TOPS)
    assert not tops & (FORBIDDEN | {"nerfjax_torch"})


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_source_names_jax_and_the_reference_names_no_program():
    for path in PB.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path
    for path in (PB / "reference").glob("*.py"):
        assert "nerfjax_torch" not in set(_imports(path)), path
