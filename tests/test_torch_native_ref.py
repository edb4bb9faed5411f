"""nerfjax's native C++ library (``nerfjax/native``) for the port's parity
tests, loaded without racing other test processes.

nerfjax builds its library on first use: every process compiles to the same
``libnerfjax_native.<digest>.so.tmp`` and renames it into place, and
``load()`` tries once per process. Under ``pytest -n 6`` processes that
reach ``load()`` together overwrite each other's temporary file, and the
losers keep ``None``. Here the library is built before any test runs: this
module is imported while a process collects the tests, and the import
builds the library, if it is missing or does not load, with nerfjax's own
command under a file lock named by the library's digest, into a file of the
process's own that is then renamed into place. Once the file is there,
nerfjax's ``load()`` only opens it. ``nerfjax_native()`` returns nerfjax's
handle, retrying a lost load. The parity target stays nerfjax's ``-O3
-march=native -fopenmp`` build.
"""

import contextlib
import ctypes
import fcntl
import os
import subprocess
import tempfile
from pathlib import Path

import pytest

from nerfjax import native

ATTEMPTS = 3


@contextlib.contextmanager
def _locked():
    lock = Path(tempfile.gettempdir()) / f"{native._lib_path().stem}.lock"
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _loads(path: Path) -> bool:
    try:
        ctypes.CDLL(str(path))
        return True
    except OSError:
        return False


def _compile(lib_path: Path) -> str:
    """nerfjax's build command (``nerfjax/native/__init__.py`` ``_build``)
    into a file of this process's own, renamed onto ``lib_path``. Its name
    ends in ``.so.tmp``, so nerfjax's stale-file glob never matches it.
    Returns the compiler's output."""
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.so.tmp")
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", str(native._SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {type(e).__name__}: {e}"
    if res.returncode == 0:
        os.replace(tmp, lib_path)
    else:
        tmp.unlink(missing_ok=True)
    return f"{' '.join(cmd)} -> {res.returncode}\n{res.stdout}{res.stderr}"


def _ensure_library() -> list[str]:
    """Under the lock, build the library unless the file in place loads.
    Returns the builds' output (empty when nothing was built)."""
    log = []
    with _locked():
        lib_path = native._lib_path()
        for _ in range(ATTEMPTS):
            if _loads(lib_path):
                break
            log.append(_compile(lib_path))
    return log


def nerfjax_native():
    """nerfjax's loaded native library (``native.load()``'s handle, so
    nerfjax's own calls in this process take its native path too). Fails
    with the build's output when it cannot be loaded in ``ATTEMPTS``
    tries."""
    log = []
    for _ in range(ATTEMPTS):
        if native._lib is not None:
            return native._lib
        log += _ensure_library()
        native._tried = False
        if native.load() is not None:
            return native._lib
    pytest.fail("nerfjax's native library did not load after "
                f"{ATTEMPTS} attempts; its builds said:\n" + "\n".join(log))


_ensure_library()  # at collection, before any test of this process runs


def test_nerfjax_native_loads_with_every_entry():
    lib = nerfjax_native()
    assert lib is native.load() is native._lib
    for name in ("knn_mean_distances", "voxelize_points", "gather_ray_batch"):
        assert getattr(lib, name).argtypes, name


def test_a_lost_load_is_retried(monkeypatch):
    """A process whose first ``native.load()`` returned None (``_tried``
    stuck, as after a lost race) gets the library on the next call."""
    lib = nerfjax_native()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert native.load() is None
    assert nerfjax_native() is not None and native._lib is not None
    assert native._lib._name == lib._name
