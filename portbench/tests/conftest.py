"""Fixtures of the benchmark's tests. Tests marked ``card`` need a CUDA
card and skip without one (decided inside the ``cuda_device`` fixture,
never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's kernels have no CPU mode at its size")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _own_tmpdir(tmp_path, monkeypatch):
    """Each test's runs write their inputs under its own TMPDIR: two test
    workers running one cell at once would share the harness's default."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
