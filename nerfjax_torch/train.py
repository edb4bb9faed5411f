"""Training on one card (counterpart of ``nerfjax/train.py``: ``build_fields``
:53-144, ``TrainSettings`` :166-246, ``_validated_single_pass`` :249-269,
``onecycle_lr_host`` :291-317, ``make_optimizer`` :320-327, ``loss_fn``
:330-373, the step :392-425, ``init_occupancy`` :486-492, ``train`` :500-).

The step follows nerfjax's order: with the occupancy grid on, every
``occ_update_every``-th step first refreshes it (1/P of its cells,
rotating); then the render draws its samples (single pass: all from the
occupancy CDF, one field pass; otherwise coarse samples, stratified or from
the grid, then importance samples from the coarse weights, and a fine pass
at all of them), the field runs in ``precision`` (bf16 matmuls with float32
parameters), compositing and the MSE losses (fine, plus coarse when not
single pass) run in float32, the backward runs the hash-grid gradient
kernels once per field pass, and AdamW steps with the OneCycle learning
rate.

Ported: the single-pass NGP paths (``cfg/blender_scene_tuned.yml``,
``cfg/blender_scene_fast.yml``) with every train-only estimator
(``hash_fwd_corners``, ``hash_grad_corners`` and ``hash_dense_corners`` of
1..8: k = 1 or leader + residual; ``hash_grad_levels``,
``hash_dense_grad_levels``), the coarse->pdf->fine path of the
reference's configs (``cfg/blender_scene.yml``: ``single_pass: false``,
with or without the grid, either CDF sampler), and vanilla NeRF
(``ngp: false``: two independent MLPs, coarse and fine, with train-time
sigma noise, on the coarse->pdf->fine path). Not ported, raising
``NotImplementedError``: more than one card (``mesh_shape``,
``shard_hash_table``).

Randomness: nerfjax folds the step into its key (``fold_in(key, step)``),
so a resumed run draws what an uninterrupted one would. The port reseeds
its ``torch.Generator`` from (seed, step) at every step for the same
property; its numbers differ from ``jax.random``'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from pathlib import Path
from typing import Mapping

import torch

from nerfjax_torch.fields.ngp import NERF_TYPE_LOG2, HashGridSpec, InstantNGP
from nerfjax_torch.fields.vanilla import VanillaNeRF
from nerfjax_torch.ops.occupancy import OccupancyGridSpec


# -- model construction -------------------------------------------------------------


def build_fields(cfg: Mapping, train: bool = False, device="cpu"):
    """(field_coarse, field_fine, shared) for a config mapping with ``.get``
    (a dict or ``nerfjax_torch.config.ConfigNode``). ``ngp: true`` shares one
    InstantNGP for both passes; ``ngp: false`` builds two independent
    VanillaNeRF MLPs (``pos_L``, ``dir_L``, ``hidden_dim``). The parameters
    are allocated, not initialised: load a checkpoint or call ``init``.

    ``train=True`` applies the train-only estimators of the config
    (``hash_fwd_corners``, ``hash_grad_corners``, ``hash_grad_levels``,
    ``hash_dense_corners``, ``hash_dense_grad_levels``) and
    makes the parameters require gradients; every other caller gets the
    exact forward.
    """
    if not cfg.get("ngp", True):
        dims = {key: int(cfg.get(key, default)) for key, default in (("pos_L", 10), ("dir_L", 4), ("hidden_dim", 256))}
        coarse, fine = VanillaNeRF(**dims, device=device), VanillaNeRF(**dims, device=device)
        if train:
            coarse.requires_grad_(True)
            fine.requires_grad_(True)
        return coarse, fine, False
    fwd_corners = int(cfg.get("hash_fwd_corners", 8)) if train else 8
    if not 1 <= fwd_corners <= 8:
        raise ValueError(f"hash_fwd_corners must be in 1..8, got {fwd_corners}")
    dense_corners = int(cfg.get("hash_dense_corners", 8)) if train else 8
    if not 1 <= dense_corners <= 8:
        raise ValueError(f"hash_dense_corners must be in 1..8, got {dense_corners}")
    grad_levels = int(cfg.get("hash_grad_levels", 0)) if train else 0
    if grad_levels < 0:
        raise ValueError(f"hash_grad_levels must be >= 0, got {grad_levels}")
    grad_corners = int(cfg.get("hash_grad_corners", 8))
    if grad_levels > 0 and grad_corners >= 8 and fwd_corners >= 8:
        raise ValueError(
            "hash_grad_levels requires a stochastic backward path (hash_grad_corners < 8 "
            "or hash_fwd_corners < 8); the exact 8-corner backward ignores level subsampling"
        )
    dense_grad_levels = int(cfg.get("hash_dense_grad_levels", 0)) if train else 0
    if dense_grad_levels < 0:
        raise ValueError(f"hash_dense_grad_levels must be >= 0, got {dense_grad_levels}")
    if dense_grad_levels > 0 and dense_corners < 8:
        raise ValueError(
            "hash_dense_grad_levels requires the exact dense forward (hash_dense_corners=8); "
            "the stochastic dense path owns its own backward"
        )
    n_levels = int(cfg.get("hash_n_levels", 16))
    if n_levels < 1:
        raise ValueError(f"hash_n_levels must be >= 1, got {n_levels}")
    nerf_type = cfg.get("nerf_type", "large")
    extra_dense = int(cfg.get("hash_extra_dense_levels", 0))
    # validate on the spec before the field allocates its table
    if nerf_type not in NERF_TYPE_LOG2:
        raise ValueError(f"Unknown nerf_type={nerf_type!r}; expected one of {sorted(NERF_TYPE_LOG2)}")
    spec = HashGridSpec(
        n_levels=n_levels,
        log2_hashmap_size=NERF_TYPE_LOG2[nerf_type],
        per_level_scale=float(cfg.get("hash_per_level_scale", 1.5)),
        grad_corners=grad_corners,
        fwd_corners=fwd_corners,
        dense_corners=dense_corners,
        grad_levels=grad_levels,
        dense_grad_levels=dense_grad_levels,
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
        grad_corners=grad_corners if train else 8,
        fwd_corners=fwd_corners,
        grad_levels=grad_levels,
        dense_corners=dense_corners,
        dense_grad_levels=dense_grad_levels,
        device=device,
    )
    if train:
        field.requires_grad_(True)
    return field, field, True


# -- settings, schedule, optimizer --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """The step's static settings (nerfjax ``TrainSettings``)."""

    n_samples: int = 64
    n_importance: int = 128
    white_bg: bool = False
    precision: str = "bf16"
    dist_last: float = 1e10
    grad_clip: float | None = None
    lr: float = 5e-4
    weight_decay: float = 1e-6
    total_steps: int = 1000
    onecycle: bool = True
    use_occupancy: bool = True
    occ_resolution: int = 128
    occ_update_every: int = 16
    occ_update_partitions: int = 1
    occ_fast_cdf: bool = False
    occ_segments: int = 128
    shard_hash_table: bool = False
    single_pass: bool = False

    @classmethod
    def from_cfg(cls, cfg: Mapping, total_steps: int) -> "TrainSettings":
        return cls(
            n_samples=cfg.get("N_samples", 64),
            n_importance=cfg.get("N_importance", 128),
            white_bg=bool(cfg.get("white_bg", False)),
            precision=cfg.get("precision", "bf16"),
            dist_last=float(cfg.get("dist_last", 1e10)),
            grad_clip=cfg.get("grad_clip", None),
            lr=float(cfg.get("lr", 5e-4)),
            weight_decay=float(cfg.get("weight_decay", 1e-6)),
            total_steps=total_steps,
            onecycle=bool(cfg.get("onecycle", True)),
            use_occupancy=bool(cfg.get("occupancy_grid", True)),
            occ_resolution=int(cfg.get("occ_resolution", 128)),
            occ_update_every=int(cfg.get("occ_update_every", 16)),
            occ_update_partitions=int(cfg.get("occ_update_partitions", 1)),
            occ_fast_cdf=bool(cfg.get("occ_fast_cdf", False)),
            occ_segments=int(cfg.get("occ_segments", 128)),
            shard_hash_table=bool(cfg.get("shard_hash_table", False)),
            single_pass=_validated_single_pass(cfg),
        )

    def occ_spec(self) -> OccupancyGridSpec:
        if self.occ_segments < 1:
            raise ValueError(f"occ_segments must be >= 1, got {self.occ_segments}")
        return OccupancyGridSpec(
            resolution=self.occ_resolution,
            update_every=self.occ_update_every,
            update_partitions=self.occ_update_partitions,
            fast_cdf=self.occ_fast_cdf,
            n_segments=self.occ_segments,
        )

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.precision == "bf16" else torch.float32


def _validated_single_pass(cfg: Mapping) -> bool:
    """single_pass requires the shared-NGP model and the occupancy grid
    (nerfjax ``_validated_single_pass``)."""
    sp = bool(cfg.get("single_pass", False))
    if sp and not cfg.get("ngp", True):
        raise ValueError(
            "single_pass: true requires ngp: true (the vanilla coarse MLP "
            "would be left untrained but still used by hierarchical eval)"
        )
    if sp and not cfg.get("occupancy_grid", True):
        raise ValueError(
            "single_pass: true requires occupancy_grid: true (all samples "
            "are drawn from the occupancy CDF; with the grid off there is "
            "no proposal distribution and no importance sampling)"
        )
    return sp


def _check_ported(s: TrainSettings) -> None:
    if s.shard_hash_table:
        raise NotImplementedError("shard_hash_table (multi-GPU) is ROADMAP Queue 1 item 'multi-GPU'")
    if s.use_occupancy:
        s.occ_spec()


def onecycle_lr_host(s: TrainSettings, count: int) -> float:
    """The OneCycle cosine learning rate after ``count`` optimizer steps:
    optax's ``cosine_onecycle_schedule`` with peak 10*lr, pct_start 0.1,
    div_factor 10, final_div_factor 100 (constant lr below 10 steps or with
    ``onecycle: false``)."""
    if not s.onecycle or s.total_steps < 10:
        return s.lr
    peak = s.lr * 10.0
    init = peak / 10.0
    final = init / 100.0
    b1 = int(0.1 * s.total_steps)
    b2 = s.total_steps
    count = max(int(count), 0)
    if count >= b2:
        return final

    def interp(a: float, b: float, pct: float) -> float:
        return b + 0.5 * (a - b) * (math.cos(math.pi * pct) + 1.0)

    if count < b1:
        return interp(init, peak, count / b1)
    return interp(peak, final, (count - b1) / (b2 - b1))


def make_optimizer(fields, s: TrainSettings):
    """(AdamW, LambdaLR) over the parameters of ``fields`` (a field, or a
    sequence of them: vanilla's coarse and fine MLPs): AdamW(betas
    0.9/0.999, eps 1e-8, weight decay on every parameter, as optax's adamw)
    with its learning rate set each step from ``onecycle_lr_host``. Not
    ``OneCycleLR``: that one cycles beta1, which nerfjax does not."""
    fields = [fields] if isinstance(fields, torch.nn.Module) else list(fields)
    opt = torch.optim.AdamW([p for f in fields for p in f.parameters()], lr=s.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=s.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda count: onecycle_lr_host(s, count) / s.lr)
    return opt, sched


def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``: every gradient times max_norm/norm
    when the global norm reaches max_norm; on the device, no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


# -- the step ------------------------------------------------------------------------


def loss_fn(field, batch: Mapping[str, torch.Tensor], settings: TrainSettings, occ_grid, *,
            field_coarse=None, u_strat=None, u_pdf=None, generator=None, noise_coarse=None, noise_fine=None):
    """(total, {loss_coarse, loss_fine, psnr}): MSE of the fine render
    against the batch colors plus, when not single pass, MSE of the coarse
    render, in float32; single pass reports a coarse loss of 0 (nerfjax
    ``loss_fn``). ``field`` is the fine field; the coarse pass runs
    ``field_coarse`` (vanilla's coarse MLP), or ``field`` when None (the
    shared NGP field). ``noise_*``: vanilla's sigma noise of each pass."""
    from nerfjax_torch.render import render_rays_planar

    _check_ported(settings)
    occ = settings.use_occupancy
    out = render_rays_planar(
        field if field_coarse is None else field_coarse, field, batch["rays_o"], batch["rays_d"], batch["t_near"],
        batch["t_far"],
        settings.n_samples, settings.n_importance, white_bg=settings.white_bg, train=True,
        dist_last=settings.dist_last, dtype=settings.dtype,
        occ_spec=settings.occ_spec() if occ else None, occ_grid=occ_grid if occ else None,
        single_pass=settings.single_pass, u_strat=u_strat, u_pdf=u_pdf, generator=generator,
        noise_coarse=noise_coarse, noise_fine=noise_fine,
    )
    loss_f = torch.mean((out["rgb_fine"].to(torch.float32) - batch["rgb"]) ** 2)
    if settings.single_pass:
        loss_c = torch.zeros_like(loss_f)
        total = loss_f
    else:
        loss_c = torch.mean((out["rgb_coarse"].to(torch.float32) - batch["rgb"]) ** 2)
        total = loss_c + loss_f
    psnr = -10.0 * torch.log10(loss_f)
    return total, {"loss_coarse": loss_c, "loss_fine": loss_f, "psnr": psnr}


@dataclasses.dataclass
class TrainState:
    """Everything a step changes: the field (the fine one: the NGP field
    both passes share, or vanilla's fine MLP), vanilla's coarse MLP
    (``field_coarse``, None for NGP), AdamW and its schedule, the occupancy
    grid (None with ``occupancy_grid: false``), the step count, and the
    generator of the step's draws."""

    settings: TrainSettings
    field: InstantNGP | VanillaNeRF
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    occ_grid: torch.Tensor | None
    generator: torch.Generator
    seed: int = 0
    step: int = 0
    field_coarse: VanillaNeRF | None = None

    def fields(self) -> list:
        """The trained fields: [field], or vanilla's [coarse, fine]."""
        return [self.field] if self.field_coarse is None else [self.field_coarse, self.field]

    def params(self) -> dict:
        """nerfjax's layout as numpy: the NGP field's param dict, or
        vanilla's {"coarse", "fine"}."""
        from nerfjax_torch.checkpoint import params_to_numpy

        if self.field_coarse is None:
            return params_to_numpy(self.field.params())
        return {"coarse": params_to_numpy(self.field_coarse.params()), "fine": params_to_numpy(self.field.params())}


def make_train_state(cfg: Mapping, settings: TrainSettings, *, seed: int = 0, device="cuda") -> TrainState:
    """A fresh state: the fields initialised from ``seed`` (NGP: tcnn's
    init; vanilla: the coarse MLP, then the fine one, from one generator),
    AdamW at step 0, the all-ones occupancy grid (none with the grid off)."""
    from nerfjax_torch.ops.occupancy import init_grid

    _check_ported(settings)
    dev = torch.device(device)
    coarse, field, shared = build_fields(cfg, train=True, device=dev)
    gen = torch.Generator().manual_seed(seed)
    fields = [field] if shared else [coarse, field]
    for f in fields:
        f.init(gen)
    opt, sched = make_optimizer(fields, settings)
    grid = init_grid(settings.occ_spec(), dev) if settings.use_occupancy else None
    return TrainState(settings, field, opt, sched, grid, torch.Generator(device=dev), seed=seed,
                      field_coarse=None if shared else coarse)


def update_occupancy(state: TrainState, *, jitter=None) -> None:
    """Refresh the grid if there is one and this step is an update step
    (nerfjax: lax.cond on step % update_every == 0; the phase advances once
    per update)."""
    from nerfjax_torch.ops.occupancy import update_grid

    if not state.settings.use_occupancy:
        return
    spec = state.settings.occ_spec()
    if state.step % spec.update_every == 0:
        phase = (state.step // spec.update_every) % spec.update_partitions
        state.occ_grid = update_grid(spec, state.occ_grid, state.field, phase, jitter=jitter,
                                     generator=state.generator, dtype=state.settings.dtype)


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor], *, u_strat=None, u_pdf=None,
               occ_jitter=None, noise_coarse=None, noise_fine=None) -> dict:
    """One step on a batch of tensors on the field's device: occupancy
    update (every update_every steps, with the grid on), render, loss,
    backward, AdamW. ``u_strat``/``u_pdf`` (the render's), ``occ_jitter``
    and vanilla's sigma noise ``noise_coarse``/``noise_fine`` override the
    generator's draws (the parity tests pass nerfjax's). Returns the step's
    metrics as 0-d tensors (no host sync)."""
    s = state.settings
    state.generator.manual_seed(state.seed * 1_000_003 + state.step)
    update_occupancy(state, jitter=occ_jitter)
    total, aux = loss_fn(state.field, batch, s, state.occ_grid, field_coarse=state.field_coarse, u_strat=u_strat,
                         u_pdf=u_pdf, generator=state.generator, noise_coarse=noise_coarse, noise_fine=noise_fine)
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    if s.grad_clip is not None:
        clip_by_global_norm_([p for f in state.fields() for p in f.parameters()], float(s.grad_clip))
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return {"loss_total": total.detach(), "loss_coarse": aux["loss_coarse"].detach(),
            "loss_fine": aux["loss_fine"].detach(), "psnr": aux["psnr"].detach()}


def restore(state: TrainState, path, steps_per_epoch: int) -> int:
    """Resume ``state`` from a port checkpoint: field, AdamW, schedule, grid
    (when the state has one) and step count. Returns the checkpoint's
    epoch."""
    from nerfjax_torch import checkpoint as ckpt

    epoch = ckpt.restore_train_state(path, state.field, state.optimizer, field_coarse=state.field_coarse)
    state.step = epoch * steps_per_epoch
    state.scheduler.last_epoch = state.step
    for group in state.optimizer.param_groups:
        group["lr"] = onecycle_lr_host(state.settings, state.step)
    if state.occ_grid is not None:
        grid = ckpt.load_occ_grid(path)
        if grid is not None and grid.shape == tuple(state.occ_grid.shape):
            state.occ_grid = torch.from_numpy(grid).to(state.occ_grid.device)
    return epoch


# -- the loop --------------------------------------------------------------------------


def train(
    cfg: Mapping,
    *,
    seed: int = 0,
    resume: bool = False,
    log_every: int = 100,
    profile_dir: str | None = None,
    device="cuda",
) -> dict:
    """Full training run (nerfjax ``train``): returns {"params" (nerfjax
    layout, numpy: ``TrainState.params``), "metrics" (the last logged),
    "psnr" (every step's),
    "total_time", "rays_per_sec", "steps"}. Writes TensorBoard scalars
    under ``output_dir/logs``, ``nerf_epoch_{E:06d}.pth`` every second
    epoch and ``nerf_final.pth`` under ``checkpoint_dir``."""
    from nerfjax_torch import checkpoint as ckpt
    from nerfjax_torch.data import RayDataset, prefetch_to_device
    from nerfjax_torch.extract import resolve_device
    from nerfjax_torch.logging_utils import Logger

    if cfg.get("mesh_shape", None) is not None:
        raise NotImplementedError("mesh_shape (multi-GPU) is ROADMAP Queue 1 item 'multi-GPU'")
    dev = resolve_device(device)
    output_dir, checkpoint_dir = Path(cfg["output_dir"]), Path(cfg["checkpoint_dir"])
    output_dir.mkdir(parents=True, exist_ok=True)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    dataset = RayDataset(cfg["rays_file"], use_memmap=bool(cfg.get("use_memmap", False)))
    batch_size, num_epochs = int(cfg["batch_size"]), int(cfg["num_epochs"])
    steps_per_epoch = dataset.steps_per_epoch(batch_size)
    settings = TrainSettings.from_cfg(cfg, num_epochs * steps_per_epoch)
    state = make_train_state(cfg, settings, seed=seed, device=dev)
    logger = Logger(output_dir / "logs")

    start_epoch = 1
    if resume:
        latest = ckpt.latest_checkpoint(checkpoint_dir)
        if latest is not None:
            start_epoch = restore(state, latest, steps_per_epoch) + 1
            print(f"Resumed from {latest} at epoch {start_epoch - 1}")
    n_params = sum(p.numel() for f in state.fields() for p in f.parameters())
    print(f"NERF: {n_params * 1e-6:.3f}M")
    print(f"Device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    print(f"White background: {settings.white_bg}")
    print(f"Starting training for {num_epochs} epochs")
    print(f"Total steps: {settings.total_steps}")

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=acts) if profile_dir else contextlib.nullcontext()
    start_time = time.time()
    rays_done = 0
    metrics_host: dict = {}
    psnr_steps: list[torch.Tensor] = []
    with profiler:
        for epoch in range(start_epoch, num_epochs + 1):
            batches = dataset.epoch_batches(batch_size, seed=seed * 100003 + epoch)
            for idx, batch in enumerate(prefetch_to_device(batches, dev)):
                metrics = train_step(state, batch)
                psnr_steps.append(metrics["psnr"])
                rays_done += batch_size
                if idx % log_every == 0:
                    metrics_host = {k: float(v) for k, v in metrics.items()}
                    elapsed = time.time() - start_time
                    rays_per_s = rays_done / max(elapsed, 1e-9)
                    print(
                        f"| Epoch: {epoch} | Iteration: {idx} | "
                        f"Loss: {metrics_host['loss_total']:.4f} "
                        f"(Coarse: {metrics_host['loss_coarse']:.4f}, "
                        f"Fine: {metrics_host['loss_fine']:.4f}) | "
                        f"PSNR: {metrics_host['psnr']:.2f} | "
                        f"Time: {elapsed:.2f}s | {rays_per_s:,.0f} rays/s |"
                    )
                    logger.scalars(epoch * steps_per_epoch + idx, {
                        "Loss/Coarse": metrics_host["loss_coarse"],
                        "Loss/Fine": metrics_host["loss_fine"],
                        "Loss/Total": metrics_host["loss_total"],
                        "PSNR": metrics_host["psnr"],
                        "Scheduler Step": onecycle_lr_host(settings, state.step - 1),
                        "rays_per_sec": rays_per_s,
                    })
            if epoch % 2 == 0:
                path = checkpoint_dir / f"nerf_epoch_{epoch:06d}.pth"
                ckpt.save_train_state(path, cfg, state.field, state.optimizer, epoch, occ_grid=state.occ_grid,
                                      field_coarse=state.field_coarse)
                print(f"Saved checkpoint to {path}")
    if profile_dir:
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(Path(profile_dir) / "trace.json"))

    final_path = checkpoint_dir / "nerf_final.pth"
    ckpt.save_train_state(final_path, cfg, state.field, state.optimizer, num_epochs, occ_grid=state.occ_grid,
                          field_coarse=state.field_coarse)
    total_time = time.time() - start_time
    print(f"Saved final models to {final_path}")
    print(f"Training completed in {total_time:.2f}s")
    print("Training completed.")
    logger.close()
    return {
        "params": state.params(),
        "metrics": metrics_host,
        "psnr": torch.stack(psnr_steps).tolist() if psnr_steps else [],
        "total_time": total_time,
        "rays_per_sec": rays_done / max(total_time, 1e-9),
        "steps": state.step,
    }
