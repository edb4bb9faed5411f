"""The benchmark's own work counts and peaks: model FLOPs and the kernels'
roofline bounds, from the configuration's widths and the cell's shapes
(never from what a kernel launches), so the count reads the same work
whatever implements it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): 989
TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM. A multiply-add is 2 FLOPs; a backward costs twice its
forward. The hash-grid interpolation adds no model FLOPs."""

from __future__ import annotations

PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least seconds: bytes at HBM speed or operations at the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16)


# -- model FLOPs per sample ------------------------------------------------------


def ngp_macs(E: int = 32, density_only: bool = False) -> int:
    """Multiply-adds of one NGP point: 32 -> 64 -> 16 density MLP and the
    32 -> 64 -> 64 -> 3 color MLP (9,408 at E = 32); density only: the
    first layer and the one sigma output of the second."""
    if density_only:
        return E * 64 + 64
    return E * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 3


def vanilla_macs(cfg: dict) -> int:
    """Multiply-adds of one point through one vanilla MLP (593,408 at 256
    wide, pos_L 10, dir_L 4)."""
    h, pd, dd = int(cfg.get("hidden_dim", 256)), 3 + 6 * int(cfg.get("pos_L", 10)), 3 + 6 * int(cfg.get("dir_L", 4))
    return pd * h + 3 * h * h + (h + pd) * h + 3 * h * h + h + h * h + (h + dd) * (h // 2) + (h // 2) * 3


def point_macs(cfg: dict) -> int:
    if cfg.get("ngp", True):
        return ngp_macs(2 * int(cfg.get("hash_n_levels", 16)))
    return vanilla_macs(cfg)


def samples_per_ray(cfg: dict) -> int:
    """Field evaluations of a ray: the coarse pass, then the fine pass at all
    depths."""
    s, i = int(cfg.get("N_samples", 64)), int(cfg.get("N_importance", 128))
    return s + (s + i)


def train_step_flops(cfg: dict) -> float:
    """Forward and backward of one step: 3 x 2 x MACs x samples."""
    return 6.0 * point_macs(cfg) * samples_per_ray(cfg) * int(cfg["batch_size"])


def render_flops(cfg: dict, rays: int) -> float:
    return 2.0 * point_macs(cfg) * samples_per_ray(cfg) * rays


def extract_flops(cfg: dict, coarse_points: int, fine_points: int) -> float:
    E = 2 * int(cfg.get("hash_n_levels", 16))
    return 2.0 * (ngp_macs(E, density_only=True) * coarse_points + ngp_macs(E) * fine_points)


# -- roofline bounds -----------------------------------------------------------------


def hash_levels(cfg: dict) -> tuple[int, int, int]:
    """(dense levels, hashed levels, table entries) of the config's grid."""
    from portbench.reference.fields import ngp_levels

    lv = ngp_levels(cfg)
    dense = sum(1 for x in lv if not x["hashed"])
    return dense, len(lv) - dense, lv[-1]["offset"] + lv[-1]["size"]


def distinct_entries(cfg: dict, pos) -> int:
    """Table entries an encode of the points ``pos`` [N, 3] (in [-1, 1])
    touches: over the levels, the distinct corner indices of the level
    (``reference.fields.level_corners``), counted on a bitmap of the
    level."""
    import torch

    from portbench.reference.fields import level_corners, ngp_levels, to01

    x01, total = to01(pos.to(torch.float32)), 0
    for lv in ngp_levels(cfg):
        seen = torch.zeros(lv["size"], dtype=torch.bool, device=pos.device)
        for idx, _ in level_corners(x01, lv):
            seen[idx] = True
        total += int(seen.sum())
    return total


def encode_fwd_bytes(cfg: dict, N: int, entries: float, out_bytes: int = 2) -> float:
    """The encode's function at N points: the positions read (12 B), both
    float32 planes of each distinct table entry touched read once (8 B an
    entry; ``distinct_entries``), the [2, L, N] encoding written. The
    program's re-layout of the table (its pack into bf16 pairs) is its own
    choice and not counted."""
    L = int(cfg.get("hash_n_levels", 16))
    return 12.0 * N + 8.0 * entries + 2.0 * L * N * out_bytes


def encode_bwd_bytes(cfg: dict, N: int, g_bytes: int = 2) -> float:
    """The table gradient at N points: positions and the [2, L, N] upstream
    gradient read, the whole [2, total] float32 gradient written once."""
    L = int(cfg.get("hash_n_levels", 16))
    return 12.0 * N + 2.0 * L * N * g_bytes + 8.0 * hash_levels(cfg)[2]


def train_hash_bound_s(cfg: dict, steps: int, entries: tuple[float, float]) -> float:
    """The hash-grid kernels' bound over ``steps`` training steps: each
    pass's forward and table gradient; ``entries``: the distinct table
    entries a step's (coarse, fine) pass touches."""
    B = int(cfg["batch_size"])
    s, i = int(cfg.get("N_samples", 64)), int(cfg.get("N_importance", 128))
    per = sum(bound_s(encode_fwd_bytes(cfg, B * n, e)) + bound_s(encode_bwd_bytes(cfg, B * n))
              for n, e in zip((s, s + i), entries))
    return steps * per


def render_hash_bound_s(cfg: dict, rays: int, entries: float) -> float:
    """Both passes' encode at ``rays`` rays, whose calls touch ``entries``
    distinct table entries in all (each chunk's pass counted apart)."""
    s, i = int(cfg.get("N_samples", 64)), int(cfg.get("N_importance", 128))
    return bound_s(encode_fwd_bytes(cfg, rays * s, entries) + encode_fwd_bytes(cfg, rays * (s + i), 0.0))


def head_bound_s(N: int, E: int = 32, density_only: bool = False, size: int = 2) -> float:
    """The fused head's function at N points of width E (bf16: ``size`` 2):
    the encoding (and the 16 SH terms) read, rgb and sigma (sigma) written,
    the weights read once; 2 FLOPs a multiply-add at the bf16 peak."""
    macs = ngp_macs(E, density_only)
    if density_only:
        nbytes = size * ((E + 1) * N + E * 64 + 64 * 16)
    else:
        nbytes = size * ((E + 16 + 4) * N + macs)
    return bound_s(nbytes, 2.0 * N * macs)
