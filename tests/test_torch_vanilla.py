"""Vanilla NeRF (``ngp: false``) in nerfjax_torch against nerfjax, at a small
width (hidden 32, pos_L 4, dir_L 2): the Fourier encodings, the field's
forward with the sigma noise off and with nerfjax's noise injected, one
two-pass train step (fp32, rtol 1e-4 as test_train_step_matches_nerfjax),
the checkpoint read both ways, a 32^3 extraction's occupancy, and the CLIs
on the CPU (train, extract_vol, render, eval_psnr) on a checkpoint both
packages read.

nerfjax's noise comes from its keys (``jax.random.split(skey, 4)[2:]``,
``jax.random.normal`` of the pass's [B * S] sigma); the port is handed
those values (``noise_coarse``/``noise_fine``), as it is handed the
sampler's uniforms.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfjax import checkpoint as jckpt
from nerfjax import render as jrender
from nerfjax.config import ConfigNode
from nerfjax.extract import extract_volume as extract_jax
from nerfjax.fields import encodings as jenc
from nerfjax.fields.vanilla import VanillaNeRF as JaxVanilla
from nerfjax.train import TrainSettings as JaxSettings
from nerfjax.train import build_fields as jax_build_fields
from nerfjax.train import init_params, loss_fn, make_optimizer
from nerfjax_torch import checkpoint as ckpt
from nerfjax_torch import extract as textract
from nerfjax_torch import render as R
from nerfjax_torch import train as T
from nerfjax_torch.fields import encodings as enc
from nerfjax_torch.fields.vanilla import VanillaNeRF
from tests.synthetic import make_image_scene, make_ray_npz

ROOT = Path(__file__).resolve().parents[1]
B = 128
SMALL = {"ngp": False, "pos_L": 4, "dir_L": 2, "hidden_dim": 32}
CFG = {**SMALL, "batch_size": B, "num_epochs": 1, "lr": 5e-3, "N_samples": 8, "N_importance": 16,
       "precision": "fp32", "occupancy_grid": False, "single_pass": False}


def _points(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("include", [True, False])
@pytest.mark.parametrize("L", [1, 2, 4, 10])
def test_fourier_encodings_match_nerfjax(L, include):
    """Both layouts, the same frequencies (float32 2^k pi): within float32
    sin/cos rounding of the two libraries."""
    x = _points(1000, L)
    assert enc.fourier_output_dim(L, include) == jenc.fourier_output_dim(L, include)
    got = enc.fourier_encode(torch.from_numpy(x), L, include).numpy()
    np.testing.assert_allclose(got, np.asarray(jenc.fourier_encode(jnp.asarray(x), L, include)), rtol=0, atol=2e-6)
    planar = enc.fourier_encode_planar(*torch.from_numpy(x.T.copy()), L, include).numpy()
    want = np.asarray(jenc.fourier_encode_planar(*jnp.asarray(x.T), L, include))
    np.testing.assert_allclose(planar, want, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(planar, got.T)  # the two layouts hold the same values


def _fields(seed: int = 0):
    """(nerfjax field, its params, the port's field holding them)."""
    jf = JaxVanilla(pos_L=4, dir_L=2, hidden_dim=32)
    params = jf.init(jax.random.PRNGKey(seed))
    field = VanillaNeRF(pos_L=4, dir_L=2, hidden_dim=32).load_params(ckpt.params_from_jax(params))
    return jf, params, field


@pytest.mark.parametrize("noise", ["off", "injected"])
def test_forward_matches_nerfjax(noise):
    """sigma and rgb of apply_planar (and the density path's features) at
    2,000 points: without noise (train=False), and with train=True and
    nerfjax's draw handed over."""
    jf, params, field = _fields()
    x, d = _points(2000, 1), _points(2000, 2)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos3, view3 = tuple(jnp.asarray(x.T)), tuple(jnp.asarray(d.T))
    kw = {}
    if noise == "injected":
        key = jax.random.PRNGKey(5)
        kw = {"rng": key, "train": True}
        draw = torch.from_numpy(np.asarray(jax.random.normal(key, (2000,), jnp.float32)))
    rgb_j, sigma_j = jf.apply_planar(params, pos3, view3, dtype=jnp.float32, **kw)
    tpos, tview = tuple(torch.from_numpy(x.T.copy())), tuple(torch.from_numpy(d.T.copy()))
    with torch.no_grad():
        if noise == "injected":
            rgb, sigma = field.apply_planar(tpos, tview, dtype=torch.float32, train=True, noise=draw)
        else:
            rgb, sigma = field.apply_planar(tpos, tview, dtype=torch.float32)
            np.testing.assert_array_equal(field.apply_planar_fused(tpos, tview)[1].numpy(), sigma.numpy())
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=1e-4, atol=1e-6)
    if noise == "injected":  # the noise moved sigma: some values cut by the ReLU that were not before
        assert (sigma.numpy() == 0).any() and not np.allclose(sigma.numpy(), field.apply_planar(tpos, tview)[1].detach())
    sig_d, feat = field.query_density_planar(tpos, dtype=torch.float32)
    sig_dj, feat_j = jf.query_density_planar(params, pos3, dtype=jnp.float32)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(feat_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sig_d.detach().numpy(), np.asarray(sig_dj), rtol=1e-4, atol=1e-5)


def test_build_fields_and_init():
    """Two independent MLPs with nerfjax's shapes; nerfjax's init laws (the
    density head 0.01 N(0, 1), bias 0.1); single_pass refused as nerfjax
    refuses it."""
    fc, ff, shared = T.build_fields(ConfigNode(SMALL))
    jfc, _, jshared = jax_build_fields(ConfigNode(SMALL))
    assert not shared and not jshared and fc is not ff
    want = jfc.init(jax.random.PRNGKey(0))
    for ours, theirs in zip(jax.tree_util.tree_leaves(ckpt.params_to_numpy(fc.params())),
                            jax.tree_util.tree_leaves(want)):
        assert ours.shape == theirs.shape
    g = torch.Generator().manual_seed(0)
    big = VanillaNeRF().init(g)  # the defaults: pos_L 10, dir_L 4, hidden 256
    assert big.pos_dim == 63 and big.dir_dim == 27 and big.skip_layers[0].w.shape == (256 + 63, 256)
    assert big.color_layers[0].w.shape == (256 + 27, 128) and torch.all(big.density.b == 0.1)
    assert 0.008 < float(big.density.w.std()) < 0.012
    bound = 1 / np.sqrt(63)
    assert float(big.pos_layers[0].w.abs().max()) <= bound
    with pytest.raises(ValueError, match="single_pass"):
        T.TrainSettings.from_cfg({**CFG, "single_pass": True}, total_steps=10)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    data = make_ray_npz(tmp_path_factory.mktemp("rays") / "r.npz", n_rays=B, seed=3)
    return {"rays_o": data["rays_o"], "rays_d": data["rays_d"], "rgb": data["rgbs"],
            "t_near": data["t_near"], "t_far": data["t_far"]}


def _flat(params) -> dict[str, np.ndarray]:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


# absolute gradient tolerances where the noise-free coarse density head's sums cancel at init
CANCELLING = {"coarse/density/b": 4e-9, "coarse/density/w": 1e-9}


@pytest.mark.parametrize("noise", ["off", "on"])
def test_train_step_matches_nerfjax(noise, batch, monkeypatch):
    """One step of both (coarse and fine MLPs, 8 + 16 samples, fp32): loss,
    PSNR, every gradient and every parameter after AdamW, with nerfjax's
    uniforms and sigma noise handed to the port (or the noise off on both
    sides). Tolerances of test_train_step_matches_nerfjax's fp32 cases: rtol
    1e-4 with a floor of 1e-4 x the largest entry of that array, except
    the coarse density head with the noise off (CANCELLING): its gradients
    sum every sample's terms, which at init cancel (the bias to 6.2e-6,
    the weights to 1.4e-6 at most), so the two sides' orders of addition
    differ by 1.39e-9 (bias) and 3.1e-10 (weights), above that floor; each
    gets an absolute tolerance of about 3x its measured difference.
    Parameters within 1e-3 x lr where |g| > 1e-6. The importance depths are
    pinned on both sides to the port's draw from its coarse weights, as in
    that test."""
    settings = T.TrainSettings.from_cfg(CFG, total_steps=100)
    settings_j = JaxSettings.from_cfg(ConfigNode(CFG), total_steps=100)
    fc, ff, _ = jax_build_fields(ConfigNode(CFG), train=True)
    if noise == "off":
        fc = ff = dataclasses.replace(fc, sigma_noise=False)
    k_init, k_train = jax.random.split(jax.random.PRNGKey(7))
    params_j = init_params(ConfigNode(CFG), k_init)
    skey = jax.random.fold_in(k_train, 0)
    k_strat, k_pdf, k_noise_c, k_noise_f = jax.random.split(skey, 4)
    S, I = settings.n_samples, settings.n_importance
    u_strat = torch.from_numpy(np.asarray(jax.random.uniform(k_strat, (B, S), jnp.float32)))
    u_pdf = torch.from_numpy(np.asarray(jax.random.uniform(k_pdf, (B, I), jnp.float32)))
    draws = {}
    if noise == "on":
        draws = {"noise_coarse": torch.from_numpy(np.asarray(jax.random.normal(k_noise_c, (B * S,), jnp.float32))),
                 "noise_fine": torch.from_numpy(np.asarray(jax.random.normal(k_noise_f, (B * (S + I),), jnp.float32)))}
    state = T.make_train_state(CFG, settings, device="cpu")
    state.field_coarse.load_params(ckpt.params_from_jax(params_j["coarse"]))
    state.field.load_params(ckpt.params_from_jax(params_j["fine"]))
    if noise == "off":
        state.field.sigma_noise = state.field_coarse.sigma_noise = False
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    real, seen = R.sample_pdf, []
    monkeypatch.setattr(R, "sample_pdf", lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1])
    with torch.no_grad():
        R.render_rays_planar(state.field_coarse, state.field, tbatch["rays_o"], tbatch["rays_d"], tbatch["t_near"],
                             tbatch["t_far"], S, I, train=True, dtype=torch.float32, u_strat=u_strat, u_pdf=u_pdf,
                             **draws)
    z_imp = seen[0].numpy()
    monkeypatch.setattr(jrender, "sample_pdf", lambda key, bins, w, n, u=None: jnp.asarray(z_imp))
    monkeypatch.setattr(R, "sample_pdf", lambda bins, w, n, *, u=None, generator=None: torch.from_numpy(z_imp))

    tx = make_optimizer(settings_j)
    (total_j, aux_j), grads_j = jax.jit(lambda p: jax.value_and_grad(loss_fn, has_aux=True)(
        p, jbatch, skey, fc, ff, settings_j, None))(params_j)
    new_j = optax.apply_updates(params_j, tx.update(grads_j, tx.init(params_j), params_j)[0])
    metrics = T.train_step(state, tbatch, u_strat=u_strat, u_pdf=u_pdf, **draws)

    rtol = 1e-4
    for name, want in (("loss_total", total_j), ("loss_fine", aux_j["loss_fine"]),
                       ("loss_coarse", aux_j["loss_coarse"]), ("psnr", aux_j["psnr"])):
        np.testing.assert_allclose(float(metrics[name]), float(want), rtol=rtol)
    grads_t = {"coarse": ckpt.params_to_numpy({k: v for k, v in _grads(state.field_coarse).items()}),
               "fine": ckpt.params_to_numpy(_grads(state.field))}
    got_g, want_g = _flat(grads_t), _flat(grads_j)
    assert got_g.keys() == want_g.keys() and len(got_g) == 2 * 2 * 12
    for name, gj in want_g.items():
        atol = max(rtol * np.abs(gj).max(), CANCELLING.get(name, 0.0) if noise == "off" else 0.0)
        np.testing.assert_allclose(got_g[name], gj, rtol=rtol, atol=atol, err_msg=name)
    after = _flat(state.params())
    lr = CFG["lr"]
    for name, pj in _flat(new_j).items():
        sure = np.abs(want_g[name]) > 1e-6
        err = np.abs(after[name] - pj)[sure]
        assert err.max(initial=0.0) <= 1e-3 * lr, (name, err.max())


def _grads(field: VanillaNeRF) -> dict:
    p = field.params()

    def g(layer):
        return {"w": layer["w"].grad, "b": layer["b"].grad}

    return {"pos_layers": [g(x) for x in p["pos_layers"]], "skip_layers": [g(x) for x in p["skip_layers"]],
            "density": g(p["density"]), "feature": g(p["feature"]), "color_layers": [g(x) for x in p["color_layers"]]}


def _ray_cfg(tmp_path: Path, **over) -> dict:
    tmp_path.mkdir(parents=True, exist_ok=True)
    rays = tmp_path / "rays.npz"
    if not rays.exists():
        make_ray_npz(rays, n_rays=256, seed=2)
    out = tmp_path / "out"
    return {**CFG, "num_epochs": 2, "rays_file": str(rays), "output_dir": str(out),
            "checkpoint_dir": str(out / "ckpt"), **over}


def test_checkpoints_both_ways(tmp_path):
    """A vanilla checkpoint of the port's train() loads in nerfjax (both
    MLPs, equal) and resumes in the port exactly (three epochs straight
    against the same run resumed from its epoch-2 checkpoint: both MLPs and
    the AdamW moments); a checkpoint nerfjax writes loads in the port, its
    AdamW moments in nerfjax's leaf order included."""
    cfg = _ray_cfg(tmp_path / "a", num_epochs=3)
    out = T.train(cfg, device="cpu", log_every=1000)
    final = Path(cfg["checkpoint_dir"]) / "nerf_final.pth"
    for which in ("coarse", "fine"):
        theirs = _flat(jckpt.load_field_params(final, ConfigNode(cfg), which)[which])
        for name, v in _flat(out["params"][which]).items():
            np.testing.assert_array_equal(theirs[name], v)
    b = _ray_cfg(tmp_path / "b", num_epochs=3)
    Path(b["checkpoint_dir"]).mkdir(parents=True)
    epoch2 = Path(cfg["checkpoint_dir"]) / "nerf_epoch_000002.pth"
    (Path(b["checkpoint_dir"]) / epoch2.name).write_bytes(epoch2.read_bytes())
    resumed = T.train(b, device="cpu", resume=True, log_every=1000)
    assert resumed["steps"] == out["steps"] == 6 and len(resumed["psnr"]) == 2
    for name, v in _flat(out["params"]).items():
        np.testing.assert_array_equal(_flat(resumed["params"])[name], v)
    fa, fb = (ckpt.load_pth(Path(c["checkpoint_dir"]) / "nerf_final.pth") for c in (cfg, b))
    assert len(fa["optimizer_state_dict"]["state"]) == 48
    for i, st in fa["optimizer_state_dict"]["state"].items():
        np.testing.assert_array_equal(st["exp_avg"], fb["optimizer_state_dict"]["state"][i]["exp_avg"])

    # nerfjax writes, the port reads
    params = init_params(ConfigNode(cfg), jax.random.PRNGKey(3))
    tx = make_optimizer(JaxSettings(total_steps=10))
    grads = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.5), params)
    opt_state = tx.update(grads, tx.init(params), params)[1]
    jpath = tmp_path / "jax.pth"
    jckpt.save_train_state(jpath, ConfigNode(cfg), params, opt_state, 4)
    for which in ("coarse", "fine"):
        got = _flat(ckpt.params_to_numpy(ckpt.load_field_params(jpath, cfg, which)[which]))
        for name, v in _flat(params[which]).items():
            np.testing.assert_array_equal(got[name], np.asarray(v))
    state = T.make_train_state(cfg, T.TrainSettings.from_cfg(cfg, 10), device="cpu")
    assert ckpt.restore_train_state(jpath, state.field, state.optimizer, field_coarse=state.field_coarse) == 4
    for name, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(state.params())[name], np.asarray(v))
    summary = jckpt._optimizer_state_dict(opt_state, 5e-3)["state"]
    for i, p in enumerate(ckpt._leaves(state.field, state.field_coarse)):
        np.testing.assert_array_equal(state.optimizer.state[p]["exp_avg"].numpy(), summary[i]["exp_avg"])
        assert tuple(p.shape) == summary[i]["exp_avg"].shape


def test_extraction_32_matches_nerfjax(tmp_path):
    """A 32^3 exact extraction of a vanilla field from one checkpoint: the
    occupancy volumes equal but for voxels whose sigma sits within 1e-4 of
    the Otsu threshold (both compute it from their own float32 sigmas)."""
    cfg = {**SMALL, "checkpoint": str(tmp_path / "c.pth"), "volume_resolution": 32}
    params = init_params(ConfigNode(cfg), jax.random.PRNGKey(11))
    jckpt.save_train_state(tmp_path / "c.pth", ConfigNode(cfg), params,
                           make_optimizer(JaxSettings(total_steps=10)).init(params), 1)
    got = textract.extract_volume(cfg, resolution=32, device="cpu", dtype=torch.float32, verbose=False)
    want = extract_jax(ConfigNode(cfg), resolution=32, dtype=jnp.float32, verbose=False)
    occ, occ_j = np.asarray(got["occupancy_volume"]), np.asarray(want["occupancy_volume"])
    assert occ.shape == occ_j.shape == (32, 32, 32)
    assert 0 < occ.sum() < occ.size
    assert (occ != occ_j).mean() <= 1e-3, (occ != occ_j).sum()


def test_vanilla_clis_on_cpu(tmp_path):
    """train, extract_vol, render and eval_psnr with ngp: false, each as
    ``python -m nerfjax_torch.cli.<tool> --device cpu``, on the checkpoint
    the first writes."""
    scene = make_image_scene(tmp_path / "scene", "s", n_frames=2, H=16, W=16)
    cfg = _ray_cfg(tmp_path, num_epochs=1)
    cfg.update(checkpoint=str(Path(cfg["checkpoint_dir"]) / "nerf_final.pth"), transforms_json=str(scene),
               volume_output_path=str(tmp_path / "out" / "volume.pth"), volume_resolution=32)
    (tmp_path / "cfg.yml").write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))

    def cli(module, *args):
        res = subprocess.run([sys.executable, "-m", f"nerfjax_torch.cli.{module}", "--cfg_path",
                              str(tmp_path / "cfg.yml"), "--device", "cpu", *args],
                             capture_output=True, text=True, cwd=ROOT, timeout=300)
        assert res.returncode == 0, res.stderr
        return res.stdout

    assert "Training completed." in cli("train")
    assert jckpt.load_field_params(cfg["checkpoint"], ConfigNode(cfg))["fine"]["pos_layers"][0]["w"].shape == (27, 32)
    cli("extract_vol", "--resolution", "32")
    assert ckpt.load_pth(cfg["volume_output_path"])["occupancy_volume"].shape == (32, 32, 32)
    assert "wrote" in cli("render", "--frame", "0", "--samples", "8", "--importance", "8")
    assert "mean PSNR over 2 frames" in cli("eval_psnr")
