"""The precisions the reference computes in: float32 (the reference), or
the control's float8 e4m3 rounding with a per-tensor scale."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def no_tf32() -> None:
    """The reference's float32 matmuls in full float32, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x as ``prec`` holds it, in float32: unchanged for "f32"; for "fp8"
    scaled so its largest magnitude is e4m3's largest, rounded to e4m3 and
    scaled back. The gradient passes through unrounded (straight through)."""
    if prec == "f32":
        return x
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}")
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b with both operands in ``prec``, accumulated in float32."""
    return torch.matmul(rnd(a, prec), rnd(b, prec))
