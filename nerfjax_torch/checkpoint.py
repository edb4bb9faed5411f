"""NGP checkpoints (counterpart of ``nerfjax/checkpoint.py``: ``_enc_col_perm``
:114-127, ``ngp_to_state_dict`` :130-148, ``ngp_from_state_dict`` :151-182,
``load_field_params`` :318-329; its ``_mlp_dims`` :102-111 is
``InstantNGP.mlp_dims`` here). ``save_field_params`` writes the state dicts of
``save_train_state`` :248-277 without the optimizer state.

The file format is nerfjax's tcnn-shaped state dict, read and written with
the jax-free ``nerfjax.pth``: ``pos_encoding.params`` is the [total, F]
table flattened entry-major, ``dmlp.params``/``cmlp.params`` the row-major
[out, in] weight matrices concatenated, the fan-in of the first density
layer in tcnn's level-major order, and a final cmlp layer zero-padded to 16
rows is accepted on read.

``params_from_jax`` carries nerfjax's numpy param dict over as tensors.
Vanilla-NeRF checkpoints are not ported yet (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from nerfjax import pth
from nerfjax_torch.fields.ngp import HashGridSpec, InstantNGP
from nerfjax_torch.train import build_fields


def _enc_col_perm(spec: HashGridSpec) -> np.ndarray:
    """perm[tcnn_col] = nerfjax_col between tcnn's level-major encoding
    columns (level*F + feature) and the plane-major runtime layout
    (feature*L + level)."""
    L, F = spec.n_levels, spec.n_features
    return np.tile(np.arange(F), L) * L + np.repeat(np.arange(L), F)


def params_from_jax(params: Mapping) -> dict:
    """nerfjax's {"table", "dmlp": [{"w"}], "cmlp": [...]} (numpy or jax
    arrays) -> the same dict of float32 CPU tensors."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    return {
        "table": t(params["table"]),
        "dmlp": [{"w": t(layer["w"])} for layer in params["dmlp"]],
        "cmlp": [{"w": t(layer["w"])} for layer in params["cmlp"]],
    }


def ngp_to_state_dict(model: InstantNGP, params: Mapping) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    sd["pos_encoding.params"] = (
        np.asarray(params["table"], np.float32).T.reshape(-1).copy()
    )
    sd["dir_encoding.params"] = np.zeros((0,), np.float32)  # SH has no params
    perm = _enc_col_perm(model.spec)
    for name in ("dmlp", "cmlp"):
        blobs = []
        for li, layer in enumerate(params[name]):
            w = np.asarray(layer["w"], np.float32).T  # [out, in]
            if name == "dmlp" and li == 0:
                w = w[:, perm]  # publish the fan-in in tcnn's level-major order
            blobs.append(w.reshape(-1))
        sd[f"{name}.params"] = np.concatenate(blobs)
    return sd


def ngp_from_state_dict(model: InstantNGP, sd: Mapping) -> dict:
    """tcnn-shaped state dict -> the param dict of float32 CPU tensors."""
    spec = model.spec
    table = (
        np.asarray(sd["pos_encoding.params"], np.float32)
        .reshape(spec.total_table_size, spec.n_features)
        .T
    )
    params: dict = {"table": torch.from_numpy(np.ascontiguousarray(table))}
    inv_perm = np.argsort(_enc_col_perm(spec))
    for name, dims in model.mlp_dims().items():
        blob = np.asarray(sd[f"{name}.params"], np.float32)
        layers = []
        off = 0
        for li, (fan_in, fan_out) in enumerate(dims):
            # tcnn pads output widths to 16; tolerate a padded final layer.
            padded_out = fan_out
            need = fan_out * fan_in
            if li == len(dims) - 1 and blob.size - off > need:
                padded_out = -(-fan_out // 16) * 16
                need = padded_out * fan_in
            w = blob[off : off + need].reshape(padded_out, fan_in)[:fan_out]
            if name == "dmlp" and li == 0:
                w = w[:, inv_perm]  # tcnn level-major -> plane-major
            layers.append({"w": torch.from_numpy(np.ascontiguousarray(w.T))})
            off += need
        params[name] = layers
    return params


def save_field_params(path: str | Path, cfg: Mapping, params: Mapping, iteration: int = 0) -> None:
    """Write an NGP field's param dict as a checkpoint both packages'
    ``load_field_params`` read: the coarse and fine state dicts of nerfjax's
    ``save_train_state`` (one shared field), without the optimizer state."""
    sd = ngp_to_state_dict(build_fields(cfg)[1], params)
    pth.save({"iteration": int(iteration), "nerf_coarse_state_dict": sd, "nerf_fine_state_dict": sd}, path)


def load_field_params(path: str | Path, cfg: Mapping, which: str = "fine") -> dict:
    """{"model": params} of the NGP field in a checkpoint (the fine state
    dict by default, as the extraction reads it)."""
    obj = pth.load(path)
    key = f"nerf_{which}_state_dict"
    if key not in obj:
        raise KeyError(f"{key} not found in checkpoint {path}")
    _, field, _ = build_fields(cfg)
    return {"model": ngp_from_state_dict(field, obj[key])}
