"""Scene configuration (the port's own copy of ``nerfjax/config.py``:
``ConfigNode`` :27-133, ``load_config`` :136-152, ``save_config`` :155-158,
``BASE_DEFAULTS`` and ``with_defaults`` :161-208; ``tests/test_torch_imports.py`` holds the two
equal).

OmegaConf-compatible YAML configs with ``${key}`` interpolation resolved
against the root (``${scene_name}``, ``${a.b.c}``, transitive references),
attribute access and ``.get``. PyYAML is imported inside ``load_config``
and ``save_config`` only: the card's machine does not promise it, and
nothing else of the port needs it.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Iterator, Mapping

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class ConfigNode(Mapping):
    """Read-mostly mapping with attribute access and lazy ${} interpolation.

    Interpolations resolve against the *root* config, like OmegaConf, so they
    stay correct if keys are overridden after load (see `merge`).
    """

    __slots__ = ("_data", "_root")

    def __init__(self, data: dict, root: "ConfigNode | None" = None):
        object.__setattr__(self, "_data", dict(data))
        object.__setattr__(self, "_root", root if root is not None else self)

    # -- resolution -------------------------------------------------------
    def _resolve_path(self, dotted: str) -> Any:
        node: Any = self._root
        for part in dotted.split("."):
            if isinstance(node, ConfigNode):
                node = node._data[part]
            elif isinstance(node, Mapping):
                node = node[part]
            else:
                raise KeyError(dotted)
        return self._resolve_value(node)

    def _resolve_value(self, value: Any) -> Any:
        if isinstance(value, str) and "${" in value:
            # Full-string reference keeps the referenced value's type.
            m = _INTERP_RE.fullmatch(value)
            if m is not None:
                return self._resolve_path(m.group(1))

            def sub(match: re.Match) -> str:
                return str(self._resolve_path(match.group(1)))

            # Iterate to support nested results that still contain ${}.
            for _ in range(10):
                new = _INTERP_RE.sub(sub, value)
                if new == value:
                    return new
                value = new
            return value
        if isinstance(value, dict):
            return ConfigNode(value, self._root)
        return value

    # -- mapping / attribute protocol --------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._resolve_value(self._data[key])

    def __getattr__(self, key: str) -> Any:
        try:
            return self._resolve_value(self._data[key])
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    # -- conversion ---------------------------------------------------------
    def to_dict(self, resolve: bool = True) -> dict:
        out = {}
        for k in self._data:
            v = self[k] if resolve else self._data[k]
            if isinstance(v, ConfigNode):
                v = v.to_dict(resolve=resolve)
            out[k] = v
        return out

    def merge(self, other: Mapping) -> "ConfigNode":
        """Shallow-ish merge: nested dicts merge recursively, scalars override."""

        def _merge(a: dict, b: Mapping) -> dict:
            out = dict(a)
            for k, v in b.items():
                if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
                    out[k] = _merge(out[k], v)
                else:
                    out[k] = v._data if isinstance(v, ConfigNode) else v
            return out

        raw = other._data if isinstance(other, ConfigNode) else other
        return ConfigNode(_merge(self._data, raw))


def load_config(path: str | Path) -> ConfigNode:
    """Load a YAML (or JSON) config file as a ConfigNode.

    Matches the reference convention where every CLI takes ``--cfg_path`` and
    does ``OmegaConf.load(path)`` (reference: scripts/train.py:373-377), and
    where transforms JSON files are also loaded through the same API
    (reference: scripts/post_process_vol.py:103).
    """
    path = Path(path)
    with open(path, "r") as f:
        if path.suffix.lower() == ".json":
            data = json.load(f)
        else:
            import yaml  # only here: the card's machine does not promise PyYAML

            data = yaml.safe_load(f)
    if not isinstance(data, dict):
        raise ValueError(f"Config root must be a mapping, got {type(data)} in {path}")
    return ConfigNode(data)


def save_config(cfg: ConfigNode | dict, path: str | Path) -> None:
    """Write ``cfg`` as YAML in its key order, ``${}`` interpolations kept
    raw (the file nerfjax's ``save_config`` writes)."""
    import yaml  # only here, as in load_config

    data = cfg.to_dict(resolve=False) if isinstance(cfg, ConfigNode) else cfg
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)


# Canonical defaults mirroring cfg/base_cfg.yml of the reference.
BASE_DEFAULTS: dict = {
    "scene_name": "scene",
    "output_dir": "./outputs/${scene_name}",
    "checkpoint_dir": "${output_dir}/checkpoints",
    "transforms_json": "transforms_${scene_name}.json",
    "rays_file": "${scene_name}_ray_data.npz",
    "volume_resolution": 512,
    "remove_upper_aabb": True,
    "visualize": False,
    "workspace": "data/${scene_name}",
    "image_dir": "${workspace}/images",
    "newSize": [512, 512],
    "rotation": True,
    "rotation_initial": None,
    "rot_order": [0, 1, 2],
    "angles": [0, 0, 0],
    "shift": [0, 0, 0],
    "scale": 0.9,
    "target_retention": 0.95,
    "outlier_nb_neighbors": 20,
    "outlier_std_ratio": 2.0,
    "percentile_bbox": {"lower": 1.0, "upper": 99.0, "padding": 0.05},
    "aabb_adjust": {"aabb_min": [0, 0, 0], "aabb_max": [0, 0, 0]},
    "checkpoint": "${checkpoint_dir}/nerf_final.pth",
    "volume_output_path": "${output_dir}/volume.pth",
    "aabb_slice": True,
    "sliced_vol_path": "${output_dir}/volume_sliced.pth",
    "colmap_dir": "./data/${scene_name}",
    "batch_size": 4096,
    "num_epochs": 1,
    "lr": 0.0005,
    "ngp": True,
    "nerf_type": "large",
    "hidden_dim": 256,
    "pos_L": 10,
    "dir_L": 4,
    "N_samples": 64,
    "N_importance": 128,
    "white_bg": False,
    "chunk_size": 32768,
    "use_memmap": False,
}


def with_defaults(cfg: ConfigNode) -> ConfigNode:
    """Overlay a loaded scene config onto the base defaults."""
    return ConfigNode(BASE_DEFAULTS).merge(cfg)
