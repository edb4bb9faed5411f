"""One training step of nerfjax_torch against nerfjax's, and the pieces
around it (schedule, AdamW, batches), at a small size of the tuned
single-pass configuration (NGP small, 8 levels, 1 promoted dense level,
24 samples per ray, 16^3 occupancy grid in 4 partitions, 8 segments, k = 1
forward and backward over 2 drawn levels).

nerfjax's step runs under ``jax.disable_jit()``, as the body of
``make_train_step``'s step (train.py:392-425) spells it: the occupancy
update, ``jax.value_and_grad(loss_fn)`` and the optax AdamW update. Compiled,
XLA's CPU backend contracts ``o + d*z`` into an FMA, which moves the
position bits the k = 1 draws are keyed on; op by op, JAX rounds the
product and the sum separately, as the port does. The port gets the
uniforms nerfjax draws (``xi`` of the sampler, the jitter of the occupancy
update), recomputed here from nerfjax's key splits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfjax.config import ConfigNode
from nerfjax.data import RayDataset as JaxRayDataset
from nerfjax.ops.occupancy import update_grid
from nerfjax.train import TrainSettings as JaxSettings
from nerfjax.train import build_fields as jax_build_fields
from nerfjax.train import init_occupancy, init_params, loss_fn, make_optimizer
from nerfjax.train import onecycle_lr_host as jax_onecycle
from nerfjax_torch import checkpoint as ckpt
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
CASES = {
    "fp32": {"precision": "fp32"},
    "fp32_twin": {"precision": "fp32", "dist_last": 1e6, "grad_clip": 1.0},
    "bf16": {},
}


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    data = make_ray_npz(tmp_path_factory.mktemp("rays") / "r.npz", n_rays=B, seed=3)
    return {"rays_o": data["rays_o"], "rays_d": data["rays_d"], "rgb": data["rgbs"],
            "t_near": data["t_near"], "t_far": data["t_far"]}


def _nerfjax_draws(settings, skey):
    """The sampler's xi and the occupancy update's jitter that nerfjax's
    step draws from skey = fold_in(key, step) (render.py:218,
    occupancy.py:77,99-101, _sample_cdf_fast's xi)."""
    k_strat = jax.random.split(skey, 4)[0]
    xi = jax.random.uniform(k_strat, (B, settings.n_samples + settings.n_importance), jnp.float32)
    spec = settings.occ_spec()
    n = spec.resolution**3 // spec.update_partitions
    keys = jax.random.split(jax.random.fold_in(skey, 777), 3)
    jitter = np.stack([np.asarray(jax.random.uniform(k, (n,), jnp.float32, -0.5, 0.5)) for k in keys])
    return torch.from_numpy(np.asarray(xi)), torch.from_numpy(jitter)


def _flat(tree) -> dict[str, np.ndarray]:
    return {"table": np.asarray(tree["table"]),
            **{f"{n}{i}": np.asarray(layer["w"]) for n in ("dmlp", "cmlp") for i, layer in enumerate(tree[n])}}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_nerfjax(case, batch):
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
    and 5e-2 x lr (bf16) absolute, at entries where |g| > 1e-6.
    """
    cfg = {**CFG, **CASES[case]}
    bf16 = case == "bf16"
    settings_j = JaxSettings.from_cfg(ConfigNode(cfg), total_steps=100)
    fc, ff, _ = jax_build_fields(ConfigNode(cfg), train=True)
    key = jax.random.PRNGKey(7)
    k_init, k_train = jax.random.split(key)
    params_j = init_params(ConfigNode(cfg), k_init)
    tx = make_optimizer(settings_j)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    skey = jax.random.fold_in(k_train, 0)
    with jax.disable_jit():
        # step 0 of make_train_step's step_fn: update (phase 0), grads, AdamW
        occ_j = update_grid(settings_j.occ_spec(), init_occupancy(settings_j), ff, params_j["model"],
                            jax.random.fold_in(skey, 777), phase=0)
        (total_j, aux_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
            params_j, jbatch, skey, fc, ff, settings_j, occ_j)
        updates, _ = tx.update(grads_j, tx.init(params_j), params_j)
        new_j = optax.apply_updates(params_j, updates)
    metrics_j = {"loss_total": total_j, **aux_j}

    settings = T.TrainSettings.from_cfg(cfg, total_steps=100)
    state = T.make_train_state(cfg, settings, device="cpu")
    state.field.load_params(ckpt.params_from_jax(params_j["model"]))
    xi, jitter = _nerfjax_draws(settings, skey)
    metrics = T.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, xi=xi, occ_jitter=jitter)

    np.testing.assert_array_equal(state.occ_grid.numpy() > 0.01, np.asarray(occ_j) > 0.01)
    rtol = 2e-2 if bf16 else 1e-4
    for name in ("loss_total", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(metrics[name]), float(metrics_j[name]), rtol=rtol)
    assert float(metrics["loss_coarse"]) == 0.0
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
        sure = np.abs(gref[name]) > 1e-6
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
