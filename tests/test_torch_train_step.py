"""One training step of nerfjax_torch against nerfjax's, and the pieces
around it (schedule, AdamW, batches), at a small size of the tuned
single-pass configuration (NGP small, 8 levels, 1 promoted dense level,
24 samples per ray, 16^3 occupancy grid in 4 partitions, 8 segments, k = 1
forward and backward over 2 drawn levels), of the fast configuration of
cfg/blender_scene_fast.yml (16 + 32 samples from the grid's exact CDF
sampler, the exact forward and the k = 2 leader + residual table gradient;
2 dense and 6 hashed levels) and of the drop-in configuration of
cfg/blender_scene.yml (two passes, 8 stratified + 16 importance samples,
no grid, the exact estimators; 2 dense and 6 hashed levels).

nerfjax's step runs under ``jax.disable_jit()``, as the body of
``make_train_step``'s step (train.py:392-425) spells it: the occupancy
update, ``jax.value_and_grad(loss_fn)`` and the optax AdamW update. Compiled,
XLA's CPU backend contracts ``o + d*z`` into an FMA, which moves the
position bits the k = 1 and k = 2 draws are keyed on; op by op, JAX rounds the
product and the sum separately, as the port does. The port gets the
uniforms nerfjax draws (``u_strat`` of the first sampler, ``u_pdf`` of the
importance sampler, the jitter of the occupancy update), recomputed here
from nerfjax's key splits.
"""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfjax import render as jrender
from nerfjax.config import ConfigNode
from nerfjax.data import RayDataset as JaxRayDataset
from nerfjax.ops.occupancy import update_grid
from nerfjax.train import TrainSettings as JaxSettings
from nerfjax.train import build_fields as jax_build_fields
from nerfjax.train import init_occupancy, init_params, loss_fn, make_optimizer
from nerfjax.train import onecycle_lr_host as jax_onecycle
from nerfjax_torch import checkpoint as ckpt
from nerfjax_torch import render as R
from nerfjax_torch import train as T
from nerfjax_torch.data import RayDataset
from tests.synthetic import make_ray_npz

B = 256
CFG = {
    "ngp": True, "nerf_type": "small", "hash_n_levels": 8, "hash_extra_dense_levels": 1,
    "batch_size": B, "num_epochs": 1, "lr": 5e-3, "N_samples": 8, "N_importance": 16,
    "precision": "bf16", "occupancy_grid": True, "single_pass": True,
    "hash_grad_corners": 1, "hash_fwd_corners": 1, "hash_grad_levels": 2,
    "occ_resolution": 16, "occ_update_every": 16, "occ_update_partitions": 4,
    "occ_fast_cdf": True, "occ_segments": 8,
}
# cfg/blender_scene.yml's sampler and estimators (its keys over CFG's)
DROP_IN = {"occupancy_grid": False, "single_pass": False, "occ_fast_cdf": False, "hash_extra_dense_levels": 0,
           "hash_grad_corners": 8, "hash_fwd_corners": 8, "hash_grad_levels": 0}
# cfg/blender_scene_fast.yml's sampler and estimators (its keys over CFG's): 16 + 32 samples from the
# grid's exact CDF sampler, the whole grid per update, the exact forward and the k = 2 leader + residual
# table gradient. The grid keeps CFG's 8 segments: over the fast cfg's 128, nerfjax's CPU cumsum and sum
# are not sequential (the port's are), so the sample positions, and with them the k = 2 draws keyed on
# their bits, differ at some points (ROADMAP Queue 3)
FAST = {"N_samples": 16, "N_importance": 32, "hash_extra_dense_levels": 0, "hash_grad_corners": 2,
        "hash_fwd_corners": 8, "hash_grad_levels": 0, "occ_fast_cdf": False, "occ_update_partitions": 1}
CASES = {
    "fp32": {"precision": "fp32"},
    "fp32_twin": {"precision": "fp32", "dist_last": 1e6, "grad_clip": 1.0},
    "bf16": {},
    "bf16_dgl1": {"hash_dense_grad_levels": 1},
    "bf16_dc1": {"hash_dense_corners": 1},
    "dropin_fp32": {**DROP_IN, "precision": "fp32"},
    "dropin_bf16": DROP_IN,
    "fast_fp32": {**FAST, "precision": "fp32"},
    "fast_bf16": FAST,
}


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    data = make_ray_npz(tmp_path_factory.mktemp("rays") / "r.npz", n_rays=B, seed=3)
    return {"rays_o": data["rays_o"], "rays_d": data["rays_d"], "rgb": data["rgbs"],
            "t_near": data["t_near"], "t_far": data["t_far"]}


def _nerfjax_draws(settings, skey):
    """The render's u_strat and u_pdf and the occupancy update's jitter that
    nerfjax's step draws from skey = fold_in(key, step) (render.py:218 and
    :274, sample_pdf's u; occupancy.py:77,99-101, _sample_cdf_fast's xi).
    u_pdf and the jitter are None where the step draws none."""
    k_strat, k_pdf = jax.random.split(skey, 4)[:2]
    n_first = settings.n_samples + (settings.n_importance if settings.single_pass else 0)
    u_strat = torch.from_numpy(np.array(jax.random.uniform(k_strat, (B, n_first), jnp.float32)))
    u_pdf = None if settings.single_pass else torch.from_numpy(
        np.array(jax.random.uniform(k_pdf, (B, settings.n_importance), jnp.float32)))
    if not settings.use_occupancy:
        return u_strat, u_pdf, None
    spec = settings.occ_spec()
    n = spec.resolution**3 // spec.update_partitions
    keys = jax.random.split(jax.random.fold_in(skey, 777), 3)
    jitter = np.stack([np.asarray(jax.random.uniform(k, (n,), jnp.float32, -0.5, 0.5)) for k in keys])
    return u_strat, u_pdf, torch.from_numpy(jitter)


def _port_importance_depths(state, batch, u_strat, u_pdf, monkeypatch) -> np.ndarray:
    """The importance depths [B, n_importance] of the port's render at the
    state's field with these uniforms (its sample_pdf's output, recorded)."""
    real, seen = R.sample_pdf, []
    monkeypatch.setattr(R, "sample_pdf", lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1])
    s = state.settings
    with torch.no_grad():
        R.render_rays_planar(state.field, state.field, batch["rays_o"], batch["rays_d"], batch["t_near"],
                             batch["t_far"], s.n_samples, s.n_importance, train=True, dtype=s.dtype,
                             u_strat=u_strat, u_pdf=u_pdf)
    assert len(seen) == 1 and seen[0].shape == (B, s.n_importance)
    return seen[0].numpy()


def _flat(tree) -> dict[str, np.ndarray]:
    return {"table": np.asarray(tree["table"]),
            **{f"{n}{i}": np.asarray(layer["w"]) for n in ("dmlp", "cmlp") for i, layer in enumerate(tree[n])}}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_nerfjax(case, batch, monkeypatch):
    """Loss, PSNR, every gradient and every parameter after AdamW.

    fp32: rtol 1e-4 (the MLP products sum in another order on each side;
    the k = 1 plans are equal, so the table gradients sum the same terms),
    with an absolute floor of 1e-4 x the largest entry of that array for
    entries where terms cancel. bf16: each side rounds its bf16 products
    and sums in its own order, and nerfjax accumulates the dense rows'
    gradient in bf16 where the port scatters in f32, so the bound is 2e-2
    relative, with a floor of 2e-2 x the largest entry. Parameters after
    AdamW: the first update is lr * g/(|g| + eps), so an entry moves by
    lr x (sign of g) unless |g| is near eps; the bound is 1e-3 x lr (fp32)
    and 5e-2 x lr (bf16) absolute, at entries where |g| > 1e-6. The bf16
    drop-in case also needs |g| above the gradient check's floor, 2e-2 x
    the largest entry: only there does that check fix the sign of g, and
    its two passes sum more cancelling terms (a gradient of 1e-6 came out
    5e-8, near eps, on the other side). That still holds 32% of the table's
    entries with |g| > 1e-6 and 86-100% of each MLP layer's; at least a
    quarter of each array's is asserted.

    The drop-in cases pin the importance depths: both steps get the ones
    the port's sampler draws from its own coarse weights with nerfjax's
    u_pdf. An importance depth in a bin of low pdf moves by the coarse
    weights' rounding over that pdf (at init the inner weights are ~1e-6,
    where 1 - exp(-sigma*delta) carries ~6e-8 of rounding: up to 2e-3 in
    depth), which would move points across grid cells;
    tests/test_torch_render_hier.py holds the sampler to nerfjax's on the
    same weights. nerfjax's drop-in step is compiled (the exact encode keys
    on no position bits; an FMA moves a position by an ulp, and the
    trilinear weights are continuous in it).
    """
    cfg = {**CFG, **CASES[case]}
    bf16 = cfg["precision"] == "bf16"
    settings = T.TrainSettings.from_cfg(cfg, total_steps=100)
    settings_j = JaxSettings.from_cfg(ConfigNode(cfg), total_steps=100)
    fc, ff, _ = jax_build_fields(ConfigNode(cfg), train=True)
    key = jax.random.PRNGKey(7)
    k_init, k_train = jax.random.split(key)
    params_j = init_params(ConfigNode(cfg), k_init)
    tx = make_optimizer(settings_j)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    skey = jax.random.fold_in(k_train, 0)
    state = T.make_train_state(cfg, settings, device="cpu")
    state.field.load_params(ckpt.params_from_jax(params_j["model"]))
    u_strat, u_pdf, jitter = _nerfjax_draws(settings, skey)
    if not settings.single_pass:
        z_imp = _port_importance_depths(state, tbatch, u_strat, u_pdf, monkeypatch)
        monkeypatch.setattr(jrender, "sample_pdf", lambda key, bins, w, n, u=None: jnp.asarray(z_imp))
        monkeypatch.setattr(R, "sample_pdf", lambda bins, w, n, *, u=None, generator=None: torch.from_numpy(z_imp))

    def grads(params, occ):
        return jax.value_and_grad(loss_fn, has_aux=True)(params, jbatch, skey, fc, ff, settings_j, occ)

    with jax.disable_jit() if settings.single_pass else contextlib.nullcontext():
        # step 0 of make_train_step's step_fn: update (phase 0), grads, AdamW
        occ_j = init_occupancy(settings_j)
        if settings_j.use_occupancy:
            occ_j = update_grid(settings_j.occ_spec(), occ_j, ff, params_j["model"],
                                jax.random.fold_in(skey, 777), phase=0)
        (total_j, aux_j), grads_j = (grads if settings.single_pass else jax.jit(grads))(params_j, occ_j)
        updates, _ = tx.update(grads_j, tx.init(params_j), params_j)
        new_j = optax.apply_updates(params_j, updates)
    metrics_j = {"loss_total": total_j, **aux_j}
    metrics = T.train_step(state, tbatch, u_strat=u_strat, u_pdf=u_pdf, occ_jitter=jitter)

    if settings.use_occupancy:
        np.testing.assert_array_equal(state.occ_grid.numpy() > 0.01, np.asarray(occ_j) > 0.01)
    else:
        assert state.occ_grid is None
    rtol = 2e-2 if bf16 else 1e-4
    for name in ("loss_total", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(metrics[name]), float(metrics_j[name]), rtol=rtol)
    if settings.single_pass:
        assert float(metrics["loss_coarse"]) == 0.0
    else:
        np.testing.assert_allclose(float(metrics["loss_coarse"]), float(metrics_j["loss_coarse"]), rtol=rtol)
        assert float(metrics["loss_coarse"]) > 0.0
    if case != "fp32_twin":  # the twin's gradients are clipped in the step
        grads_t = {"table": state.field.table.grad,
                   **{f"{n}{i}": w.grad for n in ("dmlp", "cmlp") for i, w in enumerate(getattr(state.field, n))}}
        for name, gj in _flat(grads_j["model"]).items():
            gt = grads_t[name].numpy()
            np.testing.assert_allclose(gt, gj, rtol=rtol, atol=rtol * np.abs(gj).max(), err_msg=name)
    lr = cfg["lr"]
    gref = _flat(grads_j["model"])
    after = _flat(ckpt.params_to_numpy(state.field.params()))
    for name, pj in _flat(new_j["model"]).items():
        floor = max(1e-6, rtol * np.abs(gref[name]).max()) if bf16 and not settings.single_pass else 1e-6
        sure = np.abs(gref[name]) > floor
        assert sure.sum() >= 0.25 * (np.abs(gref[name]) > 1e-6).sum(), (name, sure.mean())
        err = np.abs(after[name] - pj)[sure]
        assert err.max(initial=0.0) <= (5e-2 if bf16 else 1e-3) * lr, (name, err.max())


@pytest.mark.parametrize("total_steps", [5, 10, 97, 1000])
def test_onecycle_lr_host_matches_nerfjax(total_steps):
    s = T.TrainSettings(total_steps=total_steps, lr=5e-4)
    sj = JaxSettings(total_steps=total_steps, lr=5e-4)
    for count in range(total_steps + 3):
        assert T.onecycle_lr_host(s, count) == jax_onecycle(sj, count)


def test_lambda_lr_drives_the_onecycle_schedule():
    """The optimizer's lr before optimizer step c is the schedule at c, as
    optax evaluates its schedule at the update count."""
    s = T.TrainSettings(total_steps=50, lr=5e-4)
    field = T.build_fields({**CFG, "nerf_type": "small"}, train=True)[1]
    opt, sched = T.make_optimizer(field, s)
    for c in range(50):
        assert opt.param_groups[0]["lr"] == pytest.approx(T.onecycle_lr_host(s, c), rel=1e-12)
        opt.step()  # no gradients: the parameters stay, the schedule advances
        sched.step()


def test_adamw_two_steps_match_optax():
    """Two AdamW steps on equal gradients equal optax.adamw's: rtol 1e-5
    (optax divides the moments by the bias corrections in float32, torch
    folds them into a double step size and a float32 denominator; the
    results differ by a few float32 ulps)."""
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(2)]
    lrs = [5e-4, 7e-4]
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.AdamW([w], lr=lrs[0], betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-6)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda c: lrs[min(c, 1)] / lrs[0])
    tx = optax.adamw(learning_rate=lambda c: jnp.asarray(lrs)[jnp.minimum(c, 1)], weight_decay=1e-6)
    pj, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        w.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(pj), rtol=1e-5, atol=1e-9)


def test_epoch_batches_match_nerfjax(tmp_path):
    make_ray_npz(tmp_path / "r.npz", n_rays=1000, seed=1)
    mine = RayDataset(tmp_path / "r.npz", verbose=False)
    ref = JaxRayDataset(tmp_path / "r.npz", verbose=False)
    assert mine.steps_per_epoch(128) == ref.steps_per_epoch(128)
    got = list(mine.epoch_batches(128, seed=11))
    want = list(ref.epoch_batches(128, seed=11))
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_train_without_grid_writes_no_grid_and_resumes(tmp_path):
    """train() on the drop-in sampler (no occupancy grid): the checkpoints
    hold no occ_grid.npy record, the coarse loss is trained, and a run
    resumed from its epoch-2 checkpoint ends equal to one run straight
    through."""
    make_ray_npz(tmp_path / "r.npz", n_rays=256, seed=2)

    def cfg(name):
        out = tmp_path / name
        return {**CFG, **DROP_IN, "batch_size": 128, "num_epochs": 3, "rays_file": str(tmp_path / "r.npz"),
                "output_dir": str(out), "checkpoint_dir": str(out / "ckpt")}

    a, b = cfg("a"), cfg("b")
    ref = T.train(a, device="cpu", log_every=1000)
    epoch2 = Path(a["checkpoint_dir"]) / "nerf_epoch_000002.pth"
    final = Path(a["checkpoint_dir"]) / "nerf_final.pth"
    assert ref["steps"] == 6 and np.isfinite(ref["psnr"]).all() and ref["metrics"]["loss_coarse"] > 0
    assert ckpt.load_occ_grid(epoch2) is None and ckpt.load_occ_grid(final) is None
    Path(b["checkpoint_dir"]).mkdir(parents=True)
    (Path(b["checkpoint_dir"]) / epoch2.name).write_bytes(epoch2.read_bytes())
    got = T.train(b, device="cpu", resume=True, log_every=1000)
    assert got["steps"] == 6 and len(got["psnr"]) == 2
    for name, want in _flat(ref["params"]).items():
        np.testing.assert_array_equal(_flat(got["params"])[name], want, err_msg=name)
