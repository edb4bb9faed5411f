"""Field construction (counterpart of ``nerfjax/train.py:53-144``).

Only ``build_fields`` for inference is ported so far; the training step,
loop and their kernels are ROADMAP Queue 1's next item.
"""

from __future__ import annotations

from typing import Mapping

from nerfjax_torch.fields.ngp import NERF_TYPE_LOG2, HashGridSpec, InstantNGP


def build_fields(cfg: Mapping, train: bool = False, device="cpu"):
    """(field_coarse, field_fine, shared) for a config mapping with ``.get``
    (a dict or nerfjax's ``ConfigNode``). ``ngp: true`` shares one
    InstantNGP for both passes. The table is allocated, not initialised:
    load a checkpoint or call ``init``."""
    if train:
        raise NotImplementedError(
            "training is not ported yet (ROADMAP Queue 1: the training step); "
            "build_fields(train=True) would apply the train-only estimators"
        )
    if not cfg.get("ngp", True):
        raise NotImplementedError(
            "the vanilla NeRF field (ngp: false) is not ported yet (ROADMAP Queue 1 item 8)"
        )
    n_levels = int(cfg.get("hash_n_levels", 16))
    if n_levels < 1:
        raise ValueError(f"hash_n_levels must be >= 1, got {n_levels}")
    nerf_type = cfg.get("nerf_type", "large")
    extra_dense = int(cfg.get("hash_extra_dense_levels", 0))
    # validate on the spec before the field allocates its table
    if nerf_type not in NERF_TYPE_LOG2:
        raise ValueError(
            f"Unknown nerf_type={nerf_type!r}; expected one of {sorted(NERF_TYPE_LOG2)}"
        )
    spec = HashGridSpec(
        n_levels=n_levels,
        log2_hashmap_size=NERF_TYPE_LOG2[nerf_type],
        per_level_scale=float(cfg.get("hash_per_level_scale", 1.5)),
        extra_dense_levels=extra_dense,
    )
    levels = spec.level_params()
    if not any(lv["use_hash"] for lv in levels):
        raise ValueError(
            f"hash_extra_dense_levels={extra_dense} promotes every level of the "
            f"{n_levels}-level grid to dense storage — no hashed levels remain; lower it"
        )
    worst = max((lv for lv in levels if not lv["use_hash"]), key=lambda lv: lv["size"], default=None)
    if worst is not None and worst["size"] > (1 << 26):
        raise ValueError(
            f"hash_extra_dense_levels={extra_dense} would store a res-{worst['res']} "
            f"level dense ({worst['size']:,} entries) — lower it"
        )
    field = InstantNGP(
        nerf_type=nerf_type,
        n_levels=n_levels,
        per_level_scale=spec.per_level_scale,
        extra_dense_levels=extra_dense,
        device=device,
    )
    return field, field, True
