"""The plain versions of nerfjax_torch.probes against benchmarks/micro_probe.py
itself, its six Pallas kernels run in interpret mode on the CPU, and the
probes' entry point.

micro_probe.py is loaded as it is; only its module-level ``pl`` is replaced
by a namespace whose ``pallas_call`` adds ``interpret=True`` and records
each output, and its ``main()`` runs. The non-dot probes must be equal; the
dots are held per element to ``K·2⁻²⁴·Σ_k|a||b|`` (K = 128): both sides sum
the same K exact products (a bf16 product is exact in f32) in their own
order.
"""

import contextlib
import importlib.util
import io
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerfjax_torch import probes

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def interpreted():
    """(the outputs in call order, the printed report) of micro_probe.main()
    in interpret mode."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NERFJAX_NO_CACHE", "1")  # the module enables nerfjax's compilation cache on import
    try:
        spec = importlib.util.spec_from_file_location("micro_probe", ROOT / "benchmarks" / "micro_probe.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        mp.undo()
    outs = []

    def pallas_call(kernel, **kw):
        call = pl.pallas_call(kernel, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            outs.append(np.asarray(out))
            return out
        return run

    mod.pl = types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec)
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        mod.main()
    return outs, report.getvalue().splitlines()


def test_micro_probe_runs_six_probes_in_interpret_mode(interpreted):
    outs, lines = interpreted
    assert len(outs) == 6 and len(lines) == 6 and all(line.endswith(" OK") for line in lines), lines


@pytest.mark.parametrize("i", range(6), ids=list(probes.launch_counts))
def test_plain_version_matches_the_pallas_kernel(interpreted, i):
    x, a, b = probes.probe_inputs()
    name, _, _, plain, args, bound = probes.probes(x, a, b)[i]
    want = torch.from_numpy(interpreted[0][i])
    got = plain(*args)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if bound is None:
        assert torch.equal(got, want), name
    else:
        assert bool(((got - want).abs() <= bound).all()), (name, float((got - want).abs().max()))


def test_probes_match_the_seeded_inputs():
    x, a, b = probes.probe_inputs()
    assert x.dtype == torch.int32 and x.shape == (8, 128) and 0 <= int(x.min()) and int(x.max()) < 2**19
    assert a.shape == (128, 512) and b.shape == (128, 128) and a.dtype == b.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), np.random.default_rng(0).integers(0, 2**19, (8, 128), np.int32))


def test_main_on_cpu_prints_six_ok(capsys):
    assert probes.main(device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and all(line.endswith(" OK") for line in lines)
    assert [line.split("  ")[1].strip() for line in lines][:2] == ["reshape (8,128)->(1024,)",
                                                                   "transpose (8,128)->(128,8)"]


def test_main_reports_every_probe_and_fails_on_one(capsys, monkeypatch):
    """A probe whose kernel disagrees with its plain version prints FAIL;
    the other five still run; main returns 1."""
    monkeypatch.setattr(probes, "k_transpose", lambda x: probes.k_transpose_plain(x) + 1.0)
    assert probes.main(device="cpu") == 1
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and "transpose (8,128)->(128,8)   FAIL: AssertionError" in lines[1]
    assert sum(line.endswith(" OK") for line in lines) == 5


def test_dot_bound_covers_summation_order():
    """Summing the products in reverse order stays within the bound."""
    x, a, b = probes.probe_inputs()
    fwd = probes.k_dot_dim0_plain(a, b)
    rev = torch.zeros_like(fwd)
    for k in reversed(range(a.shape[0])):
        rev += a[k][:, None] * b[k][None, :]
    assert bool(((fwd - rev).abs() <= probes.dot_bound(a, b)).all())
    assert float((fwd - rev).abs().max()) > 0
