"""NGP checkpoints (counterpart of ``nerfjax/checkpoint.py``: ``_enc_col_perm``
:114-127, ``ngp_to_state_dict`` :130-148, ``ngp_from_state_dict`` :151-182,
``params_to_state_dicts`` :190-198, the torch-AdamW-shaped
``_optimizer_state_dict`` :211-245, ``save_train_state`` :248-277,
``load_occ_grid`` :307-315, ``load_field_params`` :318-329,
``latest_checkpoint`` :335-344; its ``_mlp_dims`` :102-111 is
``InstantNGP.mlp_dims`` here).

The file format is nerfjax's tcnn-shaped state dict, written with
``torch.save`` and read with ``torch.load(weights_only=True)``:
``pos_encoding.params`` is the [total, F] table flattened entry-major,
``dmlp.params``/``cmlp.params`` the row-major [out, in] weight matrices
concatenated, the fan-in of the first density layer in tcnn's level-major
order, and a final cmlp layer zero-padded to 16 rows is accepted on read.
Side-band records (``occ_grid.npy``) sit under ``<archive>/extra/`` of the
zip, where nerfjax puts them; ``torch.load`` ignores them.

The optimizer state is written as nerfjax writes its summary: a
torch-AdamW-shaped dict whose entries follow nerfjax's parameter-leaf order
(cmlp, dmlp, table) in nerfjax's layouts. The port resumes from it exactly:
its AdamW moments are those arrays. nerfjax's own exact resume reads an
optax side-band record the port does not write; nerfjax resumes a port
checkpoint's parameters and starts its optimizer afresh.

``params_from_jax`` carries nerfjax's numpy param dict over as tensors,
``params_to_numpy`` the other way. Vanilla-NeRF checkpoints are not ported
(ROADMAP Queue 1 item 'vanilla').
"""

from __future__ import annotations

import io
import os
import re
import zipfile
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from nerfjax_torch.fields.ngp import HashGridSpec, InstantNGP
from nerfjax_torch.train import build_fields

# -- .pth files ---------------------------------------------------------------


def _to_tensors(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().contiguous()
    if isinstance(obj, dict):
        return {k: _to_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensors(v) for v in obj)
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _to_arrays(obj):
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if isinstance(obj, dict):
        return {k: _to_arrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_arrays(v) for v in obj)
    return obj


def _archive_prefix(z: zipfile.ZipFile) -> str:
    pkl = next(n for n in z.namelist() if n.endswith("/data.pkl"))
    return pkl[: -len("/data.pkl")]


def save_pth(obj, path: str | Path, extra_records: Mapping[str, bytes] | None = None) -> None:
    """``torch.save`` of ``obj`` (numpy arrays become tensors), then each
    extra record appended to the zip under ``<archive>/extra/<name>``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_to_tensors(obj), path)
    if extra_records:
        with zipfile.ZipFile(path, "a", compression=zipfile.ZIP_STORED) as z:
            prefix = _archive_prefix(z)
            for name, blob in extra_records.items():
                z.writestr(f"{prefix}/extra/{name}", blob)


def load_pth(path: str | Path):
    """``torch.load(weights_only=True)`` with tensors as numpy arrays; reads
    the files of both packages."""
    return _to_arrays(torch.load(path, map_location="cpu", weights_only=True))


def load_extra_record(path: str | Path, name: str) -> bytes | None:
    with zipfile.ZipFile(path, "r") as z:
        rec = f"{_archive_prefix(z)}/extra/{name}"
        return z.read(rec) if rec in z.namelist() else None


# -- NGP <-> tcnn-shaped state dict ----------------------------------------------


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


def params_to_numpy(params: Mapping) -> dict:
    """The port's param dict (``InstantNGP.params()``) -> nerfjax's
    {"table", "dmlp": [{"w"}], "cmlp": [...]} of float32 numpy arrays."""
    def a(t):
        return np.array(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, dtype=np.float32)

    return {
        "table": a(params["table"]),
        "dmlp": [{"w": a(layer["w"])} for layer in params["dmlp"]],
        "cmlp": [{"w": a(layer["w"])} for layer in params["cmlp"]],
    }


def ngp_to_state_dict(model: InstantNGP, params: Mapping) -> dict[str, np.ndarray]:
    params = params_to_numpy(params)
    sd: dict[str, np.ndarray] = {}
    sd["pos_encoding.params"] = params["table"].T.reshape(-1).copy()
    sd["dir_encoding.params"] = np.zeros((0,), np.float32)  # SH has no params
    perm = _enc_col_perm(model.spec)
    for name in ("dmlp", "cmlp"):
        blobs = []
        for li, layer in enumerate(params[name]):
            w = layer["w"].T  # [out, in]
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


def params_to_state_dicts(cfg: Mapping, params: Mapping) -> tuple[dict, dict]:
    """(coarse, fine) state dicts of {"model": params}: one shared NGP field."""
    sd = ngp_to_state_dict(build_fields(cfg)[1], params["model"])
    return sd, sd


def save_field_params(path: str | Path, cfg: Mapping, params: Mapping, iteration: int = 0) -> None:
    """Write an NGP field's param dict as a checkpoint both packages'
    ``load_field_params`` read: the coarse and fine state dicts of
    ``save_train_state`` (one shared field), without the optimizer state."""
    coarse, fine = params_to_state_dicts(cfg, {"model": params})
    save_pth({"iteration": int(iteration), "nerf_coarse_state_dict": coarse, "nerf_fine_state_dict": fine}, path)


def load_field_params(path: str | Path, cfg: Mapping, which: str = "fine") -> dict:
    """{"model": params} of the NGP field in a checkpoint (the fine state
    dict by default, as the extraction reads it)."""
    obj = load_pth(path)
    key = f"nerf_{which}_state_dict"
    if key not in obj:
        raise KeyError(f"{key} not found in checkpoint {path}")
    _, field, _ = build_fields(cfg)
    return {"model": ngp_from_state_dict(field, obj[key])}


def load_field(path: str | Path, cfg: Mapping, device, which: str = "fine") -> InstantNGP:
    """The NGP field of a checkpoint on ``device`` (no default: the field's
    device decides where render_image runs), built by ``build_fields(cfg)``
    (the exact forward) and loaded with its weights."""
    _, field, _ = build_fields(cfg, device=device)
    return field.load_params(load_field_params(path, cfg, which)["model"])


# -- train state ----------------------------------------------------------------


def _leaves(field: InstantNGP) -> list[torch.nn.Parameter]:
    """The field's parameters in nerfjax's pytree-leaf order (sorted keys:
    cmlp layers, dmlp layers, table) - the order of nerfjax's optimizer
    summary."""
    return list(field.cmlp) + list(field.dmlp) + [field.table]


def optimizer_state_dict(field: InstantNGP, optimizer: torch.optim.Optimizer, lr: float) -> dict:
    """torch-AdamW-shaped summary of the optimizer, laid out as nerfjax's
    ``_optimizer_state_dict`` lays out optax's: state[i] for nerfjax's leaf
    i, with {"step", "exp_avg", "exp_avg_sq"}."""
    state: dict[int, dict] = {}
    for i, p in enumerate(_leaves(field)):
        s = optimizer.state.get(p)
        if s:
            state[i] = {
                "step": int(s["step"]),
                "exp_avg": s["exp_avg"].detach().cpu().numpy().astype(np.float32),
                "exp_avg_sq": s["exp_avg_sq"].detach().cpu().numpy().astype(np.float32),
            }
    return {
        "state": state,
        "param_groups": [
            {"lr": float(lr), "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-6,
             "params": list(range(len(state)))}
        ],
    }


def save_train_state(path: str | Path, cfg: Mapping, field: InstantNGP, optimizer, epoch: int,
                     occ_grid: torch.Tensor | None = None) -> None:
    """Epoch checkpoint: the shared field's state dicts, the optimizer
    summary, and the occupancy grid as the ``occ_grid.npy`` record."""
    coarse, fine = params_to_state_dicts(cfg, {"model": field.params()})
    obj = {
        "iteration": int(epoch),
        "nerf_coarse_state_dict": coarse,
        "nerf_fine_state_dict": fine,
        "optimizer_state_dict": optimizer_state_dict(field, optimizer, float(cfg.get("lr", 5e-4))),
    }
    extra = {}
    if occ_grid is not None:
        buf = io.BytesIO()
        np.save(buf, occ_grid.detach().cpu().numpy())
        extra["occ_grid.npy"] = buf.getvalue()
    tmp = Path(path).with_name(Path(path).name + ".tmp")
    save_pth(obj, tmp, extra_records=extra)
    os.replace(tmp, path)


def restore_train_state(path: str | Path, field: InstantNGP, optimizer) -> int:
    """Load a port checkpoint into ``field`` and ``optimizer`` (AdamW):
    parameters, moments and step count. Returns the checkpoint's epoch."""
    obj = load_pth(path)
    field.load_params(ngp_from_state_dict(field, obj["nerf_fine_state_dict"]))
    saved = obj.get("optimizer_state_dict", {}).get("state", {})
    if saved:
        sd = optimizer.state_dict()
        index = {id(p): i for i, p in enumerate(field.parameters())}
        sd["state"] = {}
        for leaf, p in enumerate(_leaves(field)):
            s = saved[leaf]
            sd["state"][index[id(p)]] = {
                "step": torch.tensor(float(s["step"])),
                "exp_avg": torch.from_numpy(np.asarray(s["exp_avg"], np.float32)),
                "exp_avg_sq": torch.from_numpy(np.asarray(s["exp_avg_sq"], np.float32)),
            }
        optimizer.load_state_dict(sd)
    return int(obj.get("iteration", 0))


def load_occ_grid(path: str | Path) -> np.ndarray | None:
    """The occupancy-grid EMA saved with a checkpoint, or None."""
    raw = load_extra_record(path, "occ_grid.npy")
    return None if raw is None else np.load(io.BytesIO(raw))


_CKPT_RE = re.compile(r"nerf_epoch_(\d+)\.pth$")


def latest_checkpoint(checkpoint_dir: str | Path) -> Path | None:
    checkpoint_dir = Path(checkpoint_dir)
    if not checkpoint_dir.exists():
        return None
    best, best_epoch = None, -1
    for p in checkpoint_dir.iterdir():
        m = _CKPT_RE.search(p.name)
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = p, int(m.group(1))
    return best
