"""Build the CUDA sources under ``nerfjax_torch/csrc`` with nvcc and load them
with ctypes (the house precedent is ``nerfjax/native/__init__.py``).

Each source is compiled on its own into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build dir>/lib<name>.<hash>.so <name>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. The build
directory ``nerfjax_torch/_build/`` is listed in ``.gitignore``.

Unlike nerfjax's native loader this one never returns None: a missing nvcc
or a failed build raises with nvcc's own message. There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in cands:
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
            "the CUDA kernels of nerfjax_torch are built from source and need the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns {"path", "seconds", "log"}: ``seconds`` is 0.0 and ``log`` empty
    when the library was already there; ``log`` holds nvcc's output (with
    ``-Xptxas -v``: registers, shared memory and spills of every kernel).
    """
    out = library_path(name)
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stderr}{res.stdout}"
        )
    tmp.replace(out)
    for stale in BUILD_DIR.glob(f"lib{name}.*.so"):
        if stale != out:
            stale.unlink(missing_ok=True)
    return {"path": out, "seconds": seconds, "log": res.stdout + res.stderr}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>``; one handle per process."""
    return ctypes.CDLL(str(build(name)["path"]))
