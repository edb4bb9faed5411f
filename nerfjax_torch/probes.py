"""The lowering probes of ``benchmarks/micro_probe.py`` on one card: the six
Pallas TPU kernels its ``probe`` runs (:19, ``pallas_call`` :21), each a
CUDA C++ kernel for sm_90a in ``nerfjax_torch/csrc/micro_probe.cu``, built by
``nerfjax_torch._build`` and called through ctypes on PyTorch's current
stream:

  * ``k_reshape`` (:36): x int32 [R, C] -> [1, R*C] float32, ``x & 127``;
  * ``k_transpose`` (:49): x int32 [R, C] -> [C, R] float32;
  * ``k_dot_dim0`` (:61): a [K, M], b [K, N] float32 -> aᵀ·b [M, N];
  * ``k_dot_dim0_bf16`` (:76): the same on bf16(a), bf16(b), float32 sums;
  * ``k_onehot_row`` (:93): [rows, C], ``out[r, c] = (r == x[0, c] >> 7)``;
  * ``k_col_slice`` (:108): [C, lanes], ``out[r, l] = (l == x[0, r] >> 7)``.

Beside each kernel stands its plain PyTorch version (``*_plain``). A wrapper
takes the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises. ``launch_counts`` counts the launches.

    python -m nerfjax_torch.probes [--device cpu]

runs the six probes on micro_probe.py's seeded inputs, prints ``name OK``
or ``name FAIL: ...`` for each (the kernel held against its plain version:
equal, the dots within ``K·2⁻²⁴·Σ|a||b|`` per element), and exits non-zero
if any failed.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys

import numpy as np
import torch

from nerfjax_torch import tracing

ROWS = 512  # the one-hot probes' rows (k_onehot_row) and lanes (k_col_slice)

launch_counts = {"k_reshape": 0, "k_transpose": 0, "k_dot_dim0": 0, "k_dot_dim0_bf16": 0,
                 "k_onehot_row": 0, "k_col_slice": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


tracing.register_counters("probes", launch_counts)


def probe_inputs(device="cpu") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """micro_probe.py's inputs: x int32 (8, 128) in [0, 2^19) (seed 0), a f32
    (128, 512) and b f32 (128, 128) standard normal (seeds 1 and 2)."""
    x = np.random.default_rng(0).integers(0, 2**19, (8, 128), np.int32)
    a = np.random.default_rng(1).normal(size=(128, 512)).astype(np.float32)
    b = np.random.default_rng(2).normal(size=(128, 128)).astype(np.float32)
    return tuple(torch.from_numpy(v).to(device) for v in (x, a, b))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


# -- plain versions ----------------------------------------------------------------


def k_reshape_plain(x: torch.Tensor) -> torch.Tensor:
    return (x.reshape(1, -1) & 127).to(torch.float32)


def k_transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous().to(torch.float32)


def k_dot_dim0_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᵀ·b in float32 (on a card, run it with TF32 off)."""
    return torch.matmul(a.t(), b)


def k_dot_dim0_bf16_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_bf16(a).t(), _bf16(b))


def k_onehot_row_plain(x: torch.Tensor, rows: int = ROWS) -> torch.Tensor:
    rows_iota = torch.arange(rows, dtype=torch.int32, device=x.device)[:, None]
    return (rows_iota == (x[0:1, :] >> 7)).to(torch.float32)


def k_col_slice_plain(x: torch.Tensor, lanes: int = ROWS) -> torch.Tensor:
    lanes_iota = torch.arange(lanes, dtype=torch.int32, device=x.device)[None, :]
    return (lanes_iota == (x[0, :, None] >> 7)).to(torch.float32)


# -- kernels -------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (first call only) and load csrc/micro_probe.cu, with typed entries."""
    from nerfjax_torch import _build

    lib = _build.load("micro_probe")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.nerf_probe_reshape.argtypes = [vp, vp, i64, vp]
    lib.nerf_probe_transpose.argtypes = [vp, vp, i32, i32, vp]
    lib.nerf_probe_dot_dim0.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.nerf_probe_onehot_row.argtypes = [vp, vp, i32, i32, vp]
    lib.nerf_probe_col_slice.argtypes = [vp, vp, i32, i32, vp]
    for fn in (lib.nerf_probe_reshape, lib.nerf_probe_transpose, lib.nerf_probe_dot_dim0,
               lib.nerf_probe_onehot_row, lib.nerf_probe_col_slice):
        fn.restype = i32
    return lib


def _on_card(name: str, *tensors: torch.Tensor, dtype: torch.dtype, dims: int = 2) -> bool:
    """False for CPU tensors (the plain version runs); checks CUDA ones."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype or t.dim() != dims or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous {dims}-d {dtype} tensors on {dev}")
    return True


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
    launch_counts[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def k_reshape(x: torch.Tensor) -> torch.Tensor:
    """x int32 [R, C] -> [1, R*C] float32 of x & 127."""
    if not _on_card("k_reshape", x, dtype=torch.int32):
        return k_reshape_plain(x)
    out = torch.empty(1, x.numel(), dtype=torch.float32, device=x.device)
    _launched("k_reshape", _lib().nerf_probe_reshape(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x)))
    return out


def k_transpose(x: torch.Tensor) -> torch.Tensor:
    """x int32 [R, C] -> xᵀ [C, R] float32."""
    if not _on_card("k_transpose", x, dtype=torch.int32):
        return k_transpose_plain(x)
    R, C = x.shape
    out = torch.empty(C, R, dtype=torch.float32, device=x.device)
    _launched("k_transpose", _lib().nerf_probe_transpose(x.data_ptr(), out.data_ptr(), R, C, _stream(x)))
    return out


def _dot(name: str, a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"{name}: a [K, M] and b [K, N] must share K, got {tuple(a.shape)} {tuple(b.shape)}")
    (K, M), N = a.shape, b.shape[1]
    out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    if out.numel():
        _launched(name, _lib().nerf_probe_dot_dim0(a.data_ptr(), b.data_ptr(), out.data_ptr(), K, M, N, int(bf16),
                                                   _stream(a)))
    return out


def k_dot_dim0(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [K, M], b [K, N] float32 -> aᵀ·b [M, N] float32, summed in the kernel."""
    if not _on_card("k_dot_dim0", a, b, dtype=torch.float32):
        return k_dot_dim0_plain(a, b)
    return _dot("k_dot_dim0", a, b, False)


def k_dot_dim0_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(a)ᵀ·bf16(b) [M, N], float32 sums, from float32 a [K, M], b [K, N]."""
    if not _on_card("k_dot_dim0_bf16", a, b, dtype=torch.float32):
        return k_dot_dim0_bf16_plain(a, b)
    return _dot("k_dot_dim0_bf16", a, b, True)


def k_onehot_row(x: torch.Tensor, rows: int = ROWS) -> torch.Tensor:
    """[rows, C] float32: out[r, c] = (r == x[0, c] >> 7), from x int32 [R, C]."""
    if not _on_card("k_onehot_row", x, dtype=torch.int32):
        return k_onehot_row_plain(x, rows)
    C = x.shape[1]
    out = torch.empty(rows, C, dtype=torch.float32, device=x.device)
    _launched("k_onehot_row", _lib().nerf_probe_onehot_row(x.data_ptr(), out.data_ptr(), rows, C, _stream(x)))
    return out


def k_col_slice(x: torch.Tensor, lanes: int = ROWS) -> torch.Tensor:
    """[C, lanes] float32: out[r, l] = (l == x[0, r] >> 7), from x int32 [R, C]."""
    if not _on_card("k_col_slice", x, dtype=torch.int32):
        return k_col_slice_plain(x, lanes)
    C = x.shape[1]
    out = torch.empty(C, lanes, dtype=torch.float32, device=x.device)
    _launched("k_col_slice", _lib().nerf_probe_col_slice(x.data_ptr(), out.data_ptr(), C, lanes, _stream(x)))
    return out


# -- the probes ------------------------------------------------------------------------


def dot_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element K·2⁻²⁴·Σ_k|a[k,i]||b[k,j]|: two float32 sums of the same K
    exact products in any order lie within it of each other."""
    return a.shape[0] * 2.0**-24 * torch.matmul(a.abs().t(), b.abs())


def check(name: str, got: torch.Tensor, ref: torch.Tensor, bound: torch.Tensor | None = None) -> float:
    """max |got - ref|; raises unless equal (shape, dtype, values) or, with
    ``bound``, within it elementwise."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against {ref.dtype} {tuple(ref.shape)}")
    err = (got - ref).abs()
    if bound is None and not torch.equal(got, ref) or bound is not None and not bool((err <= bound).all()):
        raise AssertionError(f"{name}: max |kernel - plain| {float(err.max()):.3g}")
    return float(err.max())


def probes(x, a, b) -> list[tuple[str, str, object, object, tuple, torch.Tensor | None]]:
    """(printed name, kernel, wrapper, plain version, args, dot bound or
    None) of the six probes, in micro_probe.py's order and with its names."""
    return [
        ("reshape (8,128)->(1024,)", "k_reshape", k_reshape, k_reshape_plain, (x,), None),
        ("transpose (8,128)->(128,8)", "k_transpose", k_transpose, k_transpose_plain, (x,), None),
        ("dot contract dim0 (f32)", "k_dot_dim0", k_dot_dim0, k_dot_dim0_plain, (a, b), dot_bound(a, b)),
        ("dot contract dim0 (bf16)", "k_dot_dim0_bf16", k_dot_dim0_bf16, k_dot_dim0_bf16_plain, (a, b),
         dot_bound(_bf16(a), _bf16(b))),
        ("one-hot row bcast [1,128]", "k_onehot_row", k_onehot_row, k_onehot_row_plain, (x,), None),
        ("transpose+col one-hot", "k_col_slice", k_col_slice, k_col_slice_plain, (x,), None),
    ]


def main(device="cuda") -> int:
    """Run the six probes on ``device``, print one line each; 0 if all
    passed, else 1 (after all six ran)."""
    from nerfjax_torch.extract import resolve_device

    dev = resolve_device(device)
    failed = 0
    for name, _, kern, plain, args, bound in probes(*probe_inputs(dev)):
        try:
            check(name, kern(*args), plain(*args), bound)
            print(f"  {name:28s} OK")
        except Exception as e:  # noqa: BLE001 - a report line per probe; the exit code carries it
            msg = str(e).replace("\n", " ")[:140]
            print(f"  {name:28s} FAIL: {type(e).__name__}: {msg}")
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="Run micro_probe.py's six probes through the port's kernels")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; 'cpu' runs the plain PyTorch versions)")
    sys.exit(main(p.parse_args().device))
