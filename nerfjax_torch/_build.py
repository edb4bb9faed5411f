"""Build the CUDA sources under ``nerfjax_torch/csrc`` with nvcc and load them
with ctypes (the house precedent is ``nerfjax/native/__init__.py``).

Each source is compiled on its own into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v [extra] -o <build dir>/lib<name>.<hash>.so <name>.cu

``EXTRA_FLAGS`` adds flags for one source (``hash_encode.cu`` and ``knn.cu``
are built with ``-fmad=false``: their draws and distances must round as the
plain versions' separate multiplies and adds). ``build_all`` starts one nvcc per source at once.

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
EXTRA_FLAGS = {"hash_encode": ("-fmad=false",), "knn": ("-fmad=false",)}
SOURCES = ("fused_mlp", "hash_encode", "micro_probe", "knn")


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


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every ``csrc/<name>.cu`` not yet built, one nvcc each, all
    started together. Returns {name: {"path", "seconds", "log"}}:
    ``seconds`` is 0.0 and ``log`` empty for a library already there;
    ``log`` holds nvcc's output (with ``-Xptxas -v``: registers, shared
    memory and spills of every kernel). Raises with nvcc's message if any
    build fails."""
    out: dict[str, dict] = {}
    running = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, cmd, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, cmd, tmp, path, t0) in running.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stderr}{stdout}")
            continue
        tmp.replace(path)
        for stale in BUILD_DIR.glob(f"lib{name}.*.so"):
            if stale != path:
                stale.unlink(missing_ok=True)
        out[name] = {"path": path, "seconds": seconds, "log": stdout + stderr}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library is already built
    (``build_all`` for one source)."""
    return build_all((name,))[name]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>``; one handle per process."""
    return ctypes.CDLL(str(build(name)["path"]))
