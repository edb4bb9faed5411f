"""The work counts: known values, and the same count from the same shapes."""

import json

from pb_helpers import ROOT
from portbench import work

NGP = json.loads((ROOT / "portbench" / "configs" / "ngp_dropin.json").read_text())
VAN = json.loads((ROOT / "portbench" / "configs" / "nerf_vanilla.json").read_text())


def test_macs_per_point():
    assert work.ngp_macs(32) == 9408
    assert work.ngp_macs(32, density_only=True) == 32 * 64 + 64
    assert work.vanilla_macs(VAN) == 593_408
    assert work.samples_per_ray(NGP) == 64 + 192


def test_step_flops():
    assert work.train_step_flops(NGP) == 6.0 * 9408 * 256 * 8192  # about 118 GFLOP
    assert abs(work.train_step_flops(VAN) - 3.733e12) / 3.733e12 < 1e-3
    assert work.render_flops(NGP, 1000) == 2.0 * 9408 * 256 * 1000


def test_counts_repeat_exactly():
    a = [work.train_hash_bound_s(NGP, 7, (1e6, 3e6)), work.render_hash_bound_s(NGP, 12345, 4e6),
         work.head_bound_s(3 << 20), work.extract_flops(NGP, 128**3, 64 * 4321)]
    b = [work.train_hash_bound_s(dict(NGP), 7, (1e6, 3e6)), work.render_hash_bound_s(dict(NGP), 12345, 4e6),
         work.head_bound_s(3 << 20), work.extract_flops(dict(NGP), 128**3, 64 * 4321)]
    assert a == b


def test_distinct_entries():
    import torch

    g = torch.Generator().manual_seed(5)
    pos = torch.rand(2000, 3, generator=g) * 2 - 1
    n = work.distinct_entries(NGP, pos)
    assert n == work.distinct_entries(dict(NGP), pos.clone())  # the same count from the same points
    assert work.distinct_entries(NGP, torch.cat([pos, pos])) == n  # a point touched twice counts once
    assert work.distinct_entries(NGP, pos[:1]) == 8 * 16  # one point: its 8 corners at each of 16 levels
    assert n <= 8 * 16 * 2000


def test_bounds():
    assert work.hash_levels(NGP) == (4, 12, 6_513_496)
    # the head is bound by its bytes at bf16: 52 B a point
    n = 3 << 20
    assert work.head_bound_s(n) == 2 * (52 * n + 9408) / work.HBM_BYTES_PER_S
    per_step = work.train_hash_bound_s(NGP, 1, (1e6, 3e6))
    fwd = lambda n, e: ((12 + 64) * n + 8 * e) / work.HBM_BYTES_PER_S  # noqa: E731
    bwd = lambda n: ((12 + 64) * n + 8 * 6_513_496) / work.HBM_BYTES_PER_S  # noqa: E731
    assert abs(per_step - sum(fwd(8192 * s, e) + bwd(8192 * s) for s, e in ((64, 1e6), (192, 3e6)))) < 1e-15
