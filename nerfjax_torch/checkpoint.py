"""Checkpoints (counterpart of ``nerfjax/checkpoint.py``:
``vanilla_to_state_dict`` :55-79, ``vanilla_from_state_dict`` :82-98,
``_enc_col_perm`` :114-127, ``ngp_to_state_dict`` :130-148,
``ngp_from_state_dict`` :151-182, ``params_to_state_dicts`` :190-198,
the torch-AdamW-shaped ``_optimizer_state_dict`` :211-245,
``save_train_state`` :248-277, ``load_occ_grid`` :307-315,
``load_field_params`` :318-329, ``latest_checkpoint`` :335-344; its
``_mlp_dims`` :102-111 is ``InstantNGP.mlp_dims`` here, and
``params_from_state_dicts`` :201-207 has no counterpart: the port loads
each state dict straight into its field, ``_from_state_dict``).

The file format is nerfjax's, written with ``torch.save`` and read with
``torch.load(weights_only=True)``. Vanilla (two MLPs, coarse and fine):
the reference's ``nn.Linear`` names, ``pos_layers.{0,2,4,6}``,
``skip_layers.{0,2,4,6}``, ``density_layer``, ``feature_layer``,
``color_layer.{0,2}`` (``.weight`` [out, in], ``.bias``), and the
``pos_encoding``/``dir_encoding`` ``freq_bands``. NGP: the tcnn-shaped state dict:
``pos_encoding.params`` is the [total, F] table flattened entry-major,
``dmlp.params``/``cmlp.params`` the row-major [out, in] weight matrices
concatenated, the fan-in of the first density layer in tcnn's level-major
order, and a final cmlp layer zero-padded to 16 rows is accepted on read.
Side-band records (``occ_grid.npy``) sit under ``<archive>/extra/`` of the
zip, where nerfjax puts them; ``torch.load`` ignores them.

The optimizer state is written as nerfjax writes its summary: a
torch-AdamW-shaped dict whose entries follow nerfjax's parameter-leaf order
(NGP: cmlp, dmlp, table; vanilla: the coarse MLP's leaves, then the fine
one's, each in sorted-key order) in nerfjax's layouts. The port resumes from it exactly:
its AdamW moments are those arrays. nerfjax's own exact resume reads an
optax side-band record the port does not write; nerfjax resumes a port
checkpoint's parameters and starts its optimizer afresh.

``params_from_jax`` carries nerfjax's numpy param dict of one field over as
tensors, ``params_to_numpy`` the other way (NGP's or vanilla's layout).
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
from nerfjax_torch.fields.vanilla import VanillaNeRF
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


def load_pth(path: str | Path, mmap: bool = False):
    """``torch.load(weights_only=True)`` with tensors as numpy arrays; reads
    the files of both packages. ``mmap=True`` maps the stored tensors in
    place of reading them (the arrays are then views of the file)."""
    return _to_arrays(torch.load(path, map_location="cpu", weights_only=True, mmap=mmap))


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


def _is_vanilla(params: Mapping) -> bool:
    return "pos_layers" in params


def _map_vanilla(params: Mapping, fn) -> dict:
    def lin(layer):
        return {"w": fn(layer["w"]), "b": fn(layer["b"])}

    return {"pos_layers": [lin(layer) for layer in params["pos_layers"]],
            "skip_layers": [lin(layer) for layer in params["skip_layers"]],
            "density": lin(params["density"]), "feature": lin(params["feature"]),
            "color_layers": [lin(layer) for layer in params["color_layers"]]}


def params_from_jax(params: Mapping) -> dict:
    """nerfjax's param dict of one field (NGP: {"table", "dmlp": [{"w"}],
    "cmlp": [...]}; vanilla: {"pos_layers": [{"w", "b"}], ...}; numpy or jax
    arrays) -> the same dict of float32 CPU tensors."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    if _is_vanilla(params):
        return _map_vanilla(params, t)
    return {
        "table": t(params["table"]),
        "dmlp": [{"w": t(layer["w"])} for layer in params["dmlp"]],
        "cmlp": [{"w": t(layer["w"])} for layer in params["cmlp"]],
    }


def params_to_numpy(params: Mapping) -> dict:
    """The port's param dict of one field (``InstantNGP.params()``,
    ``VanillaNeRF.params()``) -> nerfjax's layout of float32 numpy arrays."""
    def a(t):
        return np.array(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, dtype=np.float32)

    if _is_vanilla(params):
        return _map_vanilla(params, a)
    return {
        "table": a(params["table"]),
        "dmlp": [{"w": a(layer["w"])} for layer in params["dmlp"]],
        "cmlp": [{"w": a(layer["w"])} for layer in params["cmlp"]],
    }


# -- vanilla <-> the reference's nn.Linear names ----------------------------------------

_VANILLA_SEQ = {"pos_layers": (0, 2, 4, 6), "skip_layers": (0, 2, 4, 6)}


def vanilla_to_state_dict(model: VanillaNeRF, params: Mapping) -> dict[str, np.ndarray]:
    params = params_to_numpy(params)
    sd: dict[str, np.ndarray] = {
        "pos_encoding.freq_bands": (2.0 ** np.arange(model.pos_L, dtype=np.float32) * np.pi).astype(np.float32),
        "dir_encoding.freq_bands": (2.0 ** np.arange(model.dir_L, dtype=np.float32) * np.pi).astype(np.float32),
    }
    for group, idxs in _VANILLA_SEQ.items():
        for layer, torch_i in zip(params[group], idxs):
            sd[f"{group}.{torch_i}.weight"] = layer["w"].T.copy()
            sd[f"{group}.{torch_i}.bias"] = layer["b"].copy()
    for name, group in (("density_layer", "density"), ("feature_layer", "feature")):
        sd[f"{name}.weight"] = params[group]["w"].T.copy()
        sd[f"{name}.bias"] = params[group]["b"].copy()
    for layer, torch_i in zip(params["color_layers"], (0, 2)):
        sd[f"color_layer.{torch_i}.weight"] = layer["w"].T.copy()
        sd[f"color_layer.{torch_i}.bias"] = layer["b"].copy()
    return sd


def vanilla_from_state_dict(model: VanillaNeRF, sd: Mapping) -> dict:
    """The reference-named state dict -> the param dict of float32 CPU
    tensors."""
    def lin(prefix: str) -> dict:
        return {"w": torch.from_numpy(np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight"], np.float32).T)),
                "b": torch.from_numpy(np.array(sd[f"{prefix}.bias"], np.float32))}

    return {
        "pos_layers": [lin(f"pos_layers.{i}") for i in _VANILLA_SEQ["pos_layers"]],
        "skip_layers": [lin(f"skip_layers.{i}") for i in _VANILLA_SEQ["skip_layers"]],
        "density": lin("density_layer"),
        "feature": lin("feature_layer"),
        "color_layers": [lin(f"color_layer.{i}") for i in (0, 2)],
    }


def _from_state_dict(field, sd: Mapping) -> dict:
    return (vanilla_from_state_dict if isinstance(field, VanillaNeRF) else ngp_from_state_dict)(field, sd)


# -- NGP <-> tcnn ------------------------------------------------------------------------


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
    """(coarse, fine) state dicts of {"model": params} (one shared NGP
    field) or {"coarse", "fine"} (vanilla's two MLPs)."""
    fc, ff, shared = build_fields(cfg)
    if shared:
        sd = ngp_to_state_dict(ff, params["model"])
        return sd, sd
    return vanilla_to_state_dict(fc, params["coarse"]), vanilla_to_state_dict(ff, params["fine"])


def save_field_params(path: str | Path, cfg: Mapping, params: Mapping, iteration: int = 0) -> None:
    """Write a field's params as a checkpoint both packages'
    ``load_field_params`` read: the coarse and fine state dicts of
    ``save_train_state``, without the optimizer state. ``params``: the NGP
    field's param dict, or vanilla's {"coarse", "fine"}."""
    shared = build_fields(cfg)[2]
    coarse, fine = params_to_state_dicts(cfg, {"model": params} if shared else params)
    save_pth({"iteration": int(iteration), "nerf_coarse_state_dict": coarse, "nerf_fine_state_dict": fine}, path)


def load_field_params(path: str | Path, cfg: Mapping, which: str = "fine") -> dict:
    """The params of one field in a checkpoint (the fine state dict by
    default, as the extraction reads it): {"model": params} for NGP,
    {which: params} for vanilla, as nerfjax returns them."""
    obj = load_pth(path)
    key = f"nerf_{which}_state_dict"
    if key not in obj:
        raise KeyError(f"{key} not found in checkpoint {path}")
    fc, ff, shared = build_fields(cfg)
    if shared:
        return {"model": ngp_from_state_dict(ff, obj[key])}
    return {which: vanilla_from_state_dict(ff if which == "fine" else fc, obj[key])}


def load_field(path: str | Path, cfg: Mapping, device, which: str = "fine"):
    """One field of a checkpoint on ``device`` (no default: the field's
    device decides where render_image runs), built by ``build_fields(cfg)``
    (the exact forward) and loaded with its weights: the NGP field, or
    vanilla's ``which`` MLP."""
    fc, ff, shared = build_fields(cfg, device=device)
    params = load_field_params(path, cfg, which)
    if shared:
        return ff.load_params(params["model"])
    return (ff if which == "fine" else fc).load_params(params[which])


# -- train state ----------------------------------------------------------------


def _leaves(field, field_coarse=None) -> list[torch.nn.Parameter]:
    """The trained parameters in nerfjax's pytree-leaf order (sorted keys),
    the order of nerfjax's optimizer summary. NGP: cmlp layers, dmlp
    layers, table. Vanilla {"coarse", "fine"}: per MLP, color_layers,
    density, feature, pos_layers, skip_layers, each layer's b before its w."""
    if field_coarse is None:
        return list(field.cmlp) + list(field.dmlp) + [field.table]
    out = []
    for f in (field_coarse, field):
        for layer in (*f.color_layers, f.density, f.feature, *f.pos_layers, *f.skip_layers):
            out += [layer.b, layer.w]
    return out


def optimizer_state_dict(field, optimizer: torch.optim.Optimizer, lr: float, field_coarse=None) -> dict:
    """torch-AdamW-shaped summary of the optimizer, laid out as nerfjax's
    ``_optimizer_state_dict`` lays out optax's: state[i] for nerfjax's leaf
    i, with {"step", "exp_avg", "exp_avg_sq"}."""
    state: dict[int, dict] = {}
    for i, p in enumerate(_leaves(field, field_coarse)):
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


def save_train_state(path: str | Path, cfg: Mapping, field, optimizer, epoch: int,
                     occ_grid: torch.Tensor | None = None, field_coarse=None) -> None:
    """Epoch checkpoint: the state dicts (the shared NGP field twice, or
    vanilla's ``field_coarse`` and fine ``field``), the optimizer summary,
    and the occupancy grid as the ``occ_grid.npy`` record."""
    params = {"model": field.params()} if field_coarse is None else {"coarse": field_coarse.params(),
                                                                      "fine": field.params()}
    coarse, fine = params_to_state_dicts(cfg, params)
    obj = {
        "iteration": int(epoch),
        "nerf_coarse_state_dict": coarse,
        "nerf_fine_state_dict": fine,
        "optimizer_state_dict": optimizer_state_dict(field, optimizer, float(cfg.get("lr", 5e-4)), field_coarse),
    }
    extra = {}
    if occ_grid is not None:
        buf = io.BytesIO()
        np.save(buf, occ_grid.detach().cpu().numpy())
        extra["occ_grid.npy"] = buf.getvalue()
    tmp = Path(path).with_name(Path(path).name + ".tmp")
    save_pth(obj, tmp, extra_records=extra)
    os.replace(tmp, path)


def restore_train_state(path: str | Path, field, optimizer, field_coarse=None) -> int:
    """Load a port checkpoint into ``field`` (and vanilla's
    ``field_coarse``) and ``optimizer`` (AdamW): parameters, moments and
    step count. Returns the checkpoint's epoch."""
    obj = load_pth(path)
    field.load_params(_from_state_dict(field, obj["nerf_fine_state_dict"]))
    if field_coarse is not None:
        field_coarse.load_params(_from_state_dict(field_coarse, obj["nerf_coarse_state_dict"]))
    saved = obj.get("optimizer_state_dict", {}).get("state", {})
    if saved:
        sd = optimizer.state_dict()
        index = {id(p): i for i, p in enumerate(p for group in optimizer.param_groups for p in group["params"])}
        sd["state"] = {}
        for leaf, p in enumerate(_leaves(field, field_coarse)):
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
