"""nerfjax_torch's frame rendering and held-out PSNR against nerfjax's
(``nerfjax/render_image.py``, ``nerfjax/rays.py``), and the port's render
and eval_psnr CLIs on the CPU.

The port draws its own uniforms; here its ``draws`` hook hands it
nerfjax's, as nerfjax's ``render_image`` draws them: ``fold_in(key, s)``
for the chunk starting at ray s, split as ``render_rays_planar`` splits it.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax import rays as jrays
from nerfjax import render_image as jri
from nerfjax.checkpoint import load_field_params as jax_load_field_params
from nerfjax.config import ConfigNode
from nerfjax.train import build_fields as jax_build_fields
from nerfjax.train import init_params
from nerfjax_torch import rays as R
from nerfjax_torch import render_image as RI
from nerfjax_torch.checkpoint import load_field, save_field_params
from tests.synthetic import make_image_scene

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"ngp": True, "nerf_type": "small", "hash_n_levels": 6}
H = W = 16
K16 = np.array([[12.8, 0.0, 8.0], [0.0, 12.8, 8.0], [0.0, 0.0, 1.0]], np.float32)


def _jax_draws(key, n_samples: int, n_importance: int):
    """draws(s, B) -> nerfjax's (u_strat, u_pdf) of the chunk at ray s."""
    def draws(s, B):
        k_strat, k_pdf = jax.random.split(jax.random.fold_in(key, s), 4)[:2]
        return (np.asarray(jax.random.uniform(k_strat, (B, n_samples), jnp.float32)),
                np.asarray(jax.random.uniform(k_pdf, (B, n_importance), jnp.float32)))
    return draws


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A small NGP checkpoint (nerfjax's init, table redrawn in [-0.2, 0.2]
    so that the frames hold structure) written by the port."""
    params = jax.device_get(init_params(ConfigNode(SMALL), jax.random.PRNGKey(5))["model"])
    params["table"] = np.random.default_rng(6).uniform(-0.2, 0.2, params["table"].shape).astype(np.float32)
    path = tmp_path_factory.mktemp("ckpt") / "nerf_final.pth"
    save_field_params(path, SMALL, params)
    return path


def test_rays_match_nerfjax():
    poses = np.concatenate([RI.orbit_poses(3), RI.orbit_poses(2, radius=3.0, height=-0.5)])
    oj, dj = jrays.get_rays(H, W, jnp.asarray(K16), jnp.asarray(poses))
    ot, dt = R.get_rays(H, W, K16, poses)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    hj, nj, fj = jrays.ray_cube_intersection(oj.reshape(-1, 3), dj.reshape(-1, 3))
    ht, nt, ft = R.ray_cube_intersection(ot.reshape(-1, 3), dt.reshape(-1, 3))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert 0 < ht.sum() < ht.numel()
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)


def test_ray_cube_intersection_pins_zero_directions():
    o = np.array([[0.5, 0.5, 3.0], [2.0, 0.0, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0], [-1.0, -0.0, 1e-9]], np.float32)
    for a, b in zip(R.ray_cube_intersection(torch.from_numpy(o), torch.from_numpy(d)),
                    jrays.ray_cube_intersection(jnp.asarray(o), jnp.asarray(d))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_orbit_poses_match_nerfjax():
    for n, kw in ((5, {}), (3, {"radius": 3.0, "height": -1.0, "target": np.array([0.1, 0.2, 0.3])}),
                  (1, {"radius": 1e-9, "height": 2.0})):
        np.testing.assert_array_equal(RI.orbit_poses(n, **kw), jri.orbit_poses(n, **kw))


def test_render_image_matches_nerfjax(checkpoint):
    """16 x 16 in f32, chunks of 64 rays (the last one padded), nerfjax's
    draws: within 1e-3 (the end-to-end bound of tests/test_torch_render_hier.py:
    an importance depth in a low-pdf bin moves by the coarse weights'
    float32 noise over the bin's pdf); background pixels equal."""
    fj = jax_build_fields(ConfigNode(SMALL))[1]
    pj = jax_load_field_params(checkpoint, ConfigNode(SMALL))["model"]
    ft = load_field(checkpoint, SMALL, "cpu")
    c2w = RI.orbit_poses(4)[1]
    key = jax.random.PRNGKey(9)
    want = jri.render_image(fj, pj, K16, c2w, H, W, n_samples=8, n_importance=16, chunk_rays=64, key=key,
                            dtype=jnp.float32)
    got = RI.render_image(ft, K16, c2w, H, W, n_samples=8, n_importance=16, chunk_rays=64, dtype=torch.float32,
                          draws=_jax_draws(key, 8, 16))
    hit = np.asarray(jrays.ray_cube_intersection(*(a.reshape(-1, 3) for a in jrays.get_rays(
        H, W, jnp.asarray(K16), jnp.asarray(c2w)[None])))[0]).reshape(H, W)
    assert 64 < hit.sum() and hit.sum() % 64 and not hit.all()  # padded last chunk, background pixels
    assert got.shape == (H, W, 3) and got.dtype == np.float32 and got[hit].std() > 1e-2
    np.testing.assert_array_equal(got[~hit], want[~hit])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_render_image_draws_per_chunk(checkpoint):
    """Without a hook each chunk's draws come from a generator seeded with
    (seed, chunk start): the same seed renders the same frame, chunked or
    not; another seed another frame."""
    ft = load_field(checkpoint, SMALL, "cpu")
    c2w = RI.orbit_poses(4)[2]
    a = RI.render_image(ft, K16, c2w, H, W, n_samples=8, n_importance=16, chunk_rays=64, seed=3)
    b = RI.render_image(ft, K16, c2w, H, W, n_samples=8, n_importance=16, chunk_rays=64, seed=3)
    c = RI.render_image(ft, K16, c2w, H, W, n_samples=8, n_importance=16, chunk_rays=64, seed=4)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_image_scene(tmp_path_factory.mktemp("scene"), "s", n_frames=2, H=H, W=W)


def test_eval_psnr_matches_nerfjax(checkpoint, scene):
    """Both packages' eval_psnr on one checkpoint, in their default bf16,
    with nerfjax's draws (PRNGKey(i) for frame i): within 0.05 dB."""
    fj = jax_build_fields(ConfigNode(SMALL))[1]
    pj = jax_load_field_params(checkpoint, ConfigNode(SMALL))["model"]
    want = jri.eval_psnr(fj, pj, scene, n_samples=8, n_importance=16, verbose=False)
    got = RI.eval_psnr(load_field(checkpoint, SMALL, "cpu"), scene, n_samples=8, n_importance=16, verbose=False,
                       draws=lambda i, s, B: _jax_draws(jax.random.PRNGKey(i), 8, 16)(s, B))
    assert len(got["psnr_per_frame"]) == 2
    np.testing.assert_allclose(got["psnr_per_frame"], want["psnr_per_frame"], rtol=0, atol=0.05)
    assert abs(got["psnr_mean"] - want["psnr_mean"]) <= 0.05


def _cli(module: str, cfg: Path, *args: str) -> subprocess.CompletedProcess:
    res = subprocess.run([sys.executable, "-m", module, "--cfg_path", str(cfg), "--device", "cpu", *args],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    return res


def test_render_and_eval_psnr_clis_on_cpu(tmp_path, checkpoint, scene):
    from PIL import Image

    out = tmp_path / "out"
    cfg = {**SMALL, "checkpoint": str(checkpoint), "transforms_json": str(scene), "output_dir": str(out),
           "N_samples": 8, "N_importance": 16}
    (tmp_path / "cfg.yml").write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
    res = _cli("nerfjax_torch.cli.render", tmp_path / "cfg.yml", "--frame", "1", "--orbit", "2")
    names = ["frame_0001.png", "orbit_0000.png", "orbit_0001.png"]
    for name in names:
        path = out / "renders" / name
        assert f"wrote {path}" in res.stdout
        assert np.asarray(Image.open(path)).shape == (H, W, 3)
    res = _cli("nerfjax_torch.cli.eval_psnr", tmp_path / "cfg.yml", "--frames", "2")
    mean = RI.eval_psnr(load_field(checkpoint, SMALL, "cpu"), scene, n_samples=8, n_importance=16, verbose=False)
    m = re.search(r"mean PSNR over 2 frames: ([\d.]+)", res.stdout)
    assert m is not None, res.stdout
    assert m.group(1) == f"{mean['psnr_mean']:.2f}"
