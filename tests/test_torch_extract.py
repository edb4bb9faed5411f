"""The extraction slice as a whole: nerfjax_torch against nerfjax on the same
params, checkpoint interop, the CLI's volume.pth, and the jax-free import."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax import checkpoint as jckpt
from nerfjax import pth
from nerfjax.config import ConfigNode, with_defaults
from nerfjax.extract import extract_volume as extract_jax
from nerfjax.extract import load_volume
from nerfjax.train import build_fields as build_fields_jax
from nerfjax.train import init_params
from nerfjax_torch import checkpoint as tckpt
from nerfjax_torch import extract as textract

REPO = Path(__file__).resolve().parents[1]
TUNED = {"ngp": True, "nerf_type": "small", "hash_n_levels": 12, "hash_extra_dense_levels": 1}


def _cfg(tmp_path, **extra):
    return with_defaults(ConfigNode({"scene_name": "t", "output_dir": str(tmp_path), **TUNED, **extra}))


@pytest.fixture(scope="module")
def jax_params(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("p"))
    params = jax.device_get(init_params(cfg, jax.random.PRNGKey(0)))
    params["model"]["table"] = params["model"]["table"] * 2000.0  # structured field
    return params


@pytest.fixture(scope="module")
def jax_volume(tmp_path_factory, jax_params):
    """nerfjax's f32 extraction at (res, hierarchical), run once per module:
    the reference volumes are what these tests spend their time on."""
    cfg = _cfg(tmp_path_factory.mktemp("v"))
    cache = {}

    def get(res, hierarchical):
        if (res, hierarchical) not in cache:
            cache[res, hierarchical] = extract_jax(
                cfg, params=jax_params, dtype=jnp.float32, resolution=res,
                hierarchical=hierarchical, verbose=False,
            )
        return cache[res, hierarchical]

    return get


def _jax_linspace(lo, hi, res, dev):
    return torch.from_numpy(np.array(jnp.linspace(lo, hi, res, dtype=jnp.float32))).to(dev)


def _sigma_at(cfg, params, res, hierarchical, idx):
    """nerfjax's f32 sigma at flat voxel indices, at the coordinates its own
    extraction queried them (fine voxels: lo + i*step; exact: linspace)."""
    field = build_fields_jax(cfg)[1]
    i = np.stack(np.unravel_index(idx, (res, res, res)))
    if hierarchical:
        c = np.float32(-1.0) + np.arange(res, dtype=np.float32) * np.float32(2.0 / (res - 1))
    else:
        c = np.asarray(jnp.linspace(-1.0, 1.0, res, dtype=jnp.float32))
    pos3 = tuple(jnp.asarray(c[i[k]]) for k in range(3))
    view3 = tuple(jnp.full_like(pos3[0], v) for v in (0.0, 0.0, -1.0))
    _, sigma = field.apply_planar(params["model"], pos3, view3, dtype=jnp.float32)
    return np.asarray(sigma)


@pytest.mark.parametrize("hierarchical,res", [(True, 32), (False, 32), (True, 64)])
def test_extract_matches_nerfjax(tmp_path, jax_params, jax_volume, monkeypatch, res, hierarchical):
    """f32 on the CPU (nerfjax takes its unfused path there, the port the
    plain versions of its kernels). The port queries the grid at nerfjax's
    jnp.linspace coordinates here, so only float32 summation order differs:
    thresholds within 1e-5 relative; occupancy may differ only at voxels
    whose sigma lies within 2e-5 relative of the threshold, and at most
    0.5% of them; RGB at voxels both call occupied within +-1."""
    monkeypatch.setattr(textract, "_linspace", _jax_linspace)
    cfg = _cfg(tmp_path)
    a = jax_volume(res, hierarchical)
    b = textract.extract_volume(
        cfg, params={"model": tckpt.params_from_jax(jax_params["model"])}, resolution=res,
        hierarchical=hierarchical, verbose=False, device="cpu", dtype=torch.float32,
    )
    ta, tb = a["metadata"]["threshold"], b["metadata"]["threshold"]
    assert abs(ta - tb) <= 1e-5 * abs(ta)
    oa, ob = a["occupancy_volume"], b["occupancy_volume"]
    assert ob.dtype == np.uint8 and ob.shape == (res,) * 3
    assert b["rgb_volume"].dtype == np.uint8 and b["rgb_volume"].shape == (res,) * 3 + (3,)
    assert 0 < oa.sum() < res**3
    diff = np.flatnonzero(oa != ob)
    assert diff.size <= 0.005 * res**3
    if diff.size:
        sig = _sigma_at(cfg, jax_params, res, hierarchical, diff)
        assert (np.abs(sig - ta) <= 2e-5 * abs(ta)).all()
    both = (oa == 1) & (ob == 1)
    rgb_diff = np.abs(a["rgb_volume"].astype(int) - b["rgb_volume"].astype(int))[both]
    assert rgb_diff.max() <= 1
    for key in ("marked_cells", "sparse_fetch", "rgb_global_max", "total_voxels"):
        assert a["metadata"].get(key) == b["metadata"].get(key), key


def test_extract_own_grid_coordinates_bounded(tmp_path, jax_params, jax_volume):
    """With the port's own host coordinates (np.linspace) the exact sweep
    queries points up to one float32 ulp away from nerfjax's jnp.linspace
    ones. On this field (table x2000, steep) that moves the threshold by
    under 1e-3 relative (observed 8e-5) and flips under 0.05% of voxels."""
    cfg = _cfg(tmp_path)
    a = jax_volume(32, False)
    b = textract.extract_volume(
        cfg, params={"model": tckpt.params_from_jax(jax_params["model"])}, resolution=32,
        hierarchical=False, verbose=False, device="cpu", dtype=torch.float32,
    )
    ta, tb = a["metadata"]["threshold"], b["metadata"]["threshold"]
    assert abs(ta - tb) <= 1e-3 * abs(ta)
    assert (a["occupancy_volume"] != b["occupancy_volume"]).sum() <= 0.0005 * 32**3


def _parent_fetch(occ: np.ndarray, rgb: np.ndarray, res: int, sparse: bool):
    """The host fetch as it was before the volumes were finished on the card,
    frozen here as the reference: occupancy bit-packed, unpacked and counted
    on the host, the occupied voxels' RGB scattered into a zeroed volume."""
    total = res**3
    rgb_global_max = float(rgb.max())
    if sparse:
        occ_host = np.unpackbits(np.packbits(occ.reshape(-1)))[:total]
        count = int(occ_host.sum())
        K = 1 << max(12, (max(count, 1) - 1).bit_length())
        if K * 7 < total * 4:
            occupied = np.flatnonzero(occ_host)
            rgb_host = np.zeros((total, 3), np.uint8)
            rgb_host[occupied] = rgb.reshape(-1, 3)[occupied]
            return occ_host.reshape(res, res, res).astype(np.uint8), rgb_host.reshape(res, res, res, 3), True, \
                rgb_global_max
    return occ.reshape(res, res, res), rgb.reshape(res, res, res, 3), False, rgb_global_max


FETCH_CASES = {  # name -> (share of voxels occupied, sparse requested, sparse taken)
    "sparse_taken": (0.05, True, True),  # K = 4096 (the minimum) * 7 < 4 * 32^3
    "mostly_occupied_falls_back": (0.9, True, False),
    "all_empty": (0.0, True, True),
    "dense_requested": (0.05, False, False),
}


@pytest.mark.parametrize("case", list(FETCH_CASES))
def test_fetch_volumes_sparse_and_dense(case):
    """_fetch_volumes gives the frozen host algorithm's arrays bit for bit,
    its sparse_used and its rgb_global_max, which is taken before the mask."""
    share, sparse, taken = FETCH_CASES[case]
    rng = np.random.default_rng(0)
    res = 32
    occ = (rng.uniform(size=res**3) < share).astype(np.uint8)
    rgb = rng.integers(1, 200, (res**3, 3), dtype=np.uint8)  # no zero: a zeroed voxel shows
    occ[0], rgb[0] = 0, 250  # brightest voxel, unoccupied
    want = _parent_fetch(occ, rgb, res, sparse)
    got = textract._fetch_volumes(torch.from_numpy(occ), torch.from_numpy(rgb), res, sparse)
    assert got[2:] == want[2:] == (taken, 250.0)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if taken:
        assert not got[1][~got[0].astype(bool)].any() and got[1][got[0].astype(bool)].all()
    # the card's count, when the caller has read it, decides as the count made here
    again = textract._fetch_volumes(torch.from_numpy(occ), torch.from_numpy(rgb), res, sparse,
                                    occupied=int(occ.sum()))
    assert again[2:] == got[2:]
    np.testing.assert_array_equal(again[1], got[1])


@pytest.mark.parametrize("hierarchical", [True, False], ids=["hierarchical", "exact"])
def test_occupied_voxels_is_the_volume_count(tmp_path, jax_params, hierarchical):
    """The metadata's count, read from the card, is the fetched volume's."""
    vol = textract.extract_volume(
        _cfg(tmp_path), params={"model": tckpt.params_from_jax(jax_params["model"])}, resolution=32,
        hierarchical=hierarchical, verbose=False, device="cpu", dtype=torch.float32,
    )
    md, occ = vol["metadata"], vol["occupancy_volume"]
    assert 0 < md["occupied_voxels"] == int(occ.sum()) < 32**3
    assert md["occupied_ratio"] == md["occupied_voxels"] / 32**3
    assert md["sparse_fetch"] == hierarchical


def test_checkpoint_loads_equal(tmp_path, jax_params):
    """A nerfjax-written nerf_final.pth loads into the port with the tensors
    nerfjax's own loader gives, and the port writes the same state dict."""
    cfg = _cfg(tmp_path)
    model = build_fields_jax(cfg)[1]
    sd = jckpt.ngp_to_state_dict(model, jax_params["model"])
    path = tmp_path / "nerf_final.pth"
    pth.save({"iteration": 1, "nerf_coarse_state_dict": sd, "nerf_fine_state_dict": sd}, path)
    ref = jax.device_get(jckpt.load_field_params(path, cfg, which="fine"))["model"]
    got = tckpt.load_field_params(path, cfg)["model"]
    np.testing.assert_array_equal(got["table"].numpy(), np.asarray(ref["table"]))
    for name in ("dmlp", "cmlp"):
        for g, r in zip(got[name], ref[name]):
            np.testing.assert_array_equal(g["w"].numpy(), np.asarray(r["w"]))
    tsd = tckpt.ngp_to_state_dict(textract.build_fields(cfg)[1], got)
    assert set(tsd) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(tsd[k], sd[k])


def test_checkpoint_padded_final_layer(tmp_path, jax_params):
    """tcnn pads the 3-wide color output to 16 rows; both loaders drop them."""
    cfg = _cfg(tmp_path)
    model = build_fields_jax(cfg)[1]
    sd = dict(jckpt.ngp_to_state_dict(model, jax_params["model"]))
    last = np.asarray(jax_params["model"]["cmlp"][2]["w"]).T  # [3, 64]
    padded = np.concatenate([last, np.ones((13, 64), np.float32)]).reshape(-1)
    sd["cmlp.params"] = np.concatenate([sd["cmlp.params"][: -last.size], padded])
    got = tckpt.ngp_from_state_dict(textract.build_fields(cfg)[1], sd)
    ref = jckpt.ngp_from_state_dict(model, sd)
    np.testing.assert_array_equal(got["cmlp"][2]["w"].numpy(), np.asarray(ref["cmlp"][2]["w"]))


def test_port_writes_checkpoint_nerfjax_reads(tmp_path, jax_params):
    """save_field_params writes a nerf_final.pth that nerfjax's loader reads
    back to the params it was given."""
    cfg = _cfg(tmp_path)
    path = tmp_path / "nerf_final.pth"
    tckpt.save_field_params(path, cfg, tckpt.params_from_jax(jax_params["model"]), iteration=3)
    ref = jax.device_get(jckpt.load_field_params(path, cfg, which="fine"))["model"]
    np.testing.assert_array_equal(np.asarray(ref["table"]), np.asarray(jax_params["model"]["table"]))
    for name in ("dmlp", "cmlp"):
        for r, w in zip(ref[name], jax_params["model"][name]):
            np.testing.assert_array_equal(np.asarray(r["w"]), np.asarray(w["w"]))
    assert pth.load(path)["iteration"] == 3


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_writes_volume_nerfjax_reads(tmp_path, jax_params, jax_volume):
    cfg = _cfg(tmp_path)
    sd = jckpt.ngp_to_state_dict(build_fields_jax(cfg)[1], jax_params["model"])
    ckpt_path = tmp_path / "nerf_final.pth"
    pth.save({"iteration": 1, "nerf_coarse_state_dict": sd, "nerf_fine_state_dict": sd}, ckpt_path)
    vol_path = tmp_path / "volume.pth"
    cfg_path = tmp_path / "cfg.yml"
    lines = [f"{k}: {str(v).lower() if isinstance(v, bool) else v}" for k, v in TUNED.items()]
    lines += [f"checkpoint: {ckpt_path}", f"volume_output_path: {vol_path}"]
    cfg_path.write_text("\n".join(lines) + "\n")
    cmd = [sys.executable, "-m", "nerfjax_torch.cli.extract_vol", "--cfg_path", str(cfg_path),
           "--device", "cpu", "-r", "32"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=_env(), cwd=tmp_path, timeout=300)
    assert res.returncode == 0, res.stderr
    got = load_volume(vol_path)
    mine = textract.load_volume(vol_path)
    for k in ("occupancy_volume", "rgb_volume"):
        np.testing.assert_array_equal(mine[k], got[k])
    assert mine["metadata"] == got["metadata"]
    ref = jax_volume(32, False)  # the CLI's 32^3 run is the exact sweep
    assert set(got) == {"occupancy_volume", "rgb_volume", "metadata"}
    for k in ("occupancy_volume", "rgb_volume"):
        assert got[k].dtype == ref[k].dtype == np.uint8
        assert got[k].shape == ref[k].shape
    assert set(ref["metadata"]) <= set(got["metadata"])


def test_cli_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text("ngp: true\nnerf_type: small\nhash_n_levels: 4\n")
    cmd = [sys.executable, "-m", "nerfjax_torch.cli.extract_vol", "--cfg_path", str(cfg_path), "-r", "8"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=_env(), cwd=tmp_path, timeout=120)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert not (tmp_path / "outputs").exists()


def test_failed_build_raises_with_nvcc_message(tmp_path, monkeypatch):
    from nerfjax_torch import _build

    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'fused_mlp.cu(1): error: made-up failure' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="made-up failure"):
        _build.build("fused_mlp")
    assert not list((tmp_path / "build").glob("*.so"))


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import importlib, pkgutil, nerfjax_torch\n"
        "for m in pkgutil.walk_packages(nerfjax_torch.__path__, 'nerfjax_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "assert 'yaml' not in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(), timeout=120)
    assert res.returncode == 0, res.stderr
