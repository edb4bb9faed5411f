"""Training (counterpart of ``nerfjax/train.py``: ``build_fields``
:53-144, ``TrainSettings`` :166-246, ``_validated_single_pass`` :249-269,
``onecycle_lr_host`` :291-317, ``make_optimizer`` :320-327, ``loss_fn``
:330-373, the step :392-425, ``table_shardings`` :445-483,
``init_occupancy`` :486-492, ``train`` :500-).

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
sigma noise, on the coarse->pdf->fine path).

Several cards (one process per card, ``nerfjax_torch.parallel``): every
rank steps on its block of the global batch, with the draws the one-rank
step makes for the whole batch (``_global_draws``), and the gradients are
averaged over the world, one ``all_reduce`` per parameter in a fixed order,
so a step over W ranks equals the one-rank step up to the order of
summation. The occupancy grid is replicated and updated identically on
every rank. ``shard_hash_table`` splits the hash table and its AdamW
moments along T over the mesh's model axis (``TableShard``): before each
forward the table is all-gathered, its reduced gradient is cut to the
rank's slice and AdamW steps that slice, so the two table modes give equal
parameters. ``mesh_shape: [dp, tp]`` picks the 2-D mesh. Rank 0 alone
makes the directories, prints, writes TensorBoard and checkpoints; every
rank joins the gathers before a save; resume is read by rank 0 and
broadcast.

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
from typing import TYPE_CHECKING, Mapping

import torch
import torch.distributed as dist

from nerfjax_torch import tracing
from nerfjax_torch.fields.ngp import NERF_TYPE_LOG2, HashGridSpec, InstantNGP
from nerfjax_torch.fields.vanilla import VanillaNeRF
from nerfjax_torch.ops.occupancy import OccupancyGridSpec

if TYPE_CHECKING:
    from nerfjax_torch.parallel import Mesh


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
    grid (None with ``occupancy_grid: false``), the step count, the
    generator of the step's draws, and, over several ranks, the mesh (None:
    no collectives) and the table's shard (``shard_hash_table``)."""

    settings: TrainSettings
    field: InstantNGP | VanillaNeRF
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    occ_grid: torch.Tensor | None
    generator: torch.Generator
    seed: int = 0
    step: int = 0
    field_coarse: VanillaNeRF | None = None
    mesh: "Mesh | None" = None
    shard: "TableShard | None" = None

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


class TableShard:
    """This rank's slice of the hash table under ``shard_hash_table``
    (nerfjax ``table_shardings``): columns [i*S, (i+1)*S) of the [2, T]
    table, S = ceil(T / n), over the n ranks of the mesh's model axis, i
    this rank's place there (the last slice zero-padded to S). ``param`` is
    what AdamW steps, so the moments it keeps are 1/n of the table's; the
    field's full table is refreshed from the slices by ``gather`` before
    each forward and before a save."""

    def __init__(self, field: InstantNGP, mesh):
        self.field, self.group, self.n = field, mesh.table_group, mesh.table_size
        T = field.table.shape[1]
        self.size = -(-T // self.n)
        self.lo = min(T, mesh.table_index * self.size)
        self.hi = min(T, self.lo + self.size)
        self.param = torch.nn.Parameter(self.cut(field.table.detach()))

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's [2, S] slice of a [2, T] tensor (zero-padded)."""
        out = full.new_zeros(full.shape[0], self.size)
        out[:, : self.hi - self.lo] = full[:, self.lo : self.hi]
        return out

    def joined(self, part: torch.Tensor) -> torch.Tensor:
        """The [2, T] tensor whose slices the model axis' ranks hold."""
        from nerfjax_torch.parallel import all_gather

        parts = [part] if self.n == 1 else all_gather(part, self.group)
        return torch.cat(parts, dim=1)[:, : self.field.table.shape[1]]

    @torch.no_grad()
    def gather(self) -> None:
        self.field.table.copy_(self.joined(self.param.detach()))

    def take_grad(self) -> None:
        """The (reduced) table gradient, cut to this rank's slice."""
        table = self.field.table
        self.param.grad = self.cut(table.grad)
        table.grad = None

    def moments(self, optimizer: torch.optim.Optimizer) -> dict:
        """The table's AdamW state with the whole moments (every rank of the
        model axis joins)."""
        st = optimizer.state[self.param]
        return {"step": st["step"], "exp_avg": self.joined(st["exp_avg"]),
                "exp_avg_sq": self.joined(st["exp_avg_sq"])}


def shard_table(state: TrainState) -> None:
    """Split ``state``'s hash table over its mesh's model axis: AdamW steps
    the rank's slice (with its slice of any restored moments) in place of
    the table. Vanilla NeRF has no table: nothing changes, as in nerfjax."""
    field = state.field
    if state.field_coarse is not None or not isinstance(field, InstantNGP):
        return
    shard = TableShard(field, state.mesh)
    opt = state.optimizer
    for group in opt.param_groups:
        group["params"] = [shard.param if p is field.table else p for p in group["params"]]
    st = opt.state.pop(field.table, None)
    if st:
        opt.state[shard.param] = {"step": st["step"], "exp_avg": shard.cut(st["exp_avg"]),
                                  "exp_avg_sq": shard.cut(st["exp_avg_sq"])}
    state.shard = shard


def _collective(state: TrainState) -> bool:
    return state.mesh is not None and dist.is_initialized()


def _global_draws(state: TrainState, B: int, given: dict) -> dict:
    """This rank's rows of the draws the one-rank step makes for the global
    batch, in its order: the first depths' uniforms, then (two passes) the
    coarse sigma noise, the importance uniforms and the fine sigma noise.
    Draws given by the caller are left out, as the one-rank step leaves
    them out. The position-keyed corner draws need nothing: they follow
    from the positions."""
    s, W, r = state.settings, state.mesh.world, state.mesh.rank
    gen, dev, Bg = state.generator, next(state.field.parameters()).device, B * W
    rows = slice(r * B, (r + 1) * B)
    out = dict(given)
    n_first = s.n_samples + s.n_importance if s.single_pass else s.n_samples

    def noise(S):
        flat = torch.randn(Bg * S, generator=gen, device=dev, dtype=s.dtype)
        return flat[r * B * S : (r + 1) * B * S]

    if out["u_strat"] is None:
        out["u_strat"] = torch.rand(Bg, n_first, generator=gen, device=dev)[rows]
    if not s.single_pass:
        coarse = state.field_coarse if state.field_coarse is not None else state.field
        if out["noise_coarse"] is None and getattr(coarse, "sigma_noise", False):
            out["noise_coarse"] = noise(s.n_samples)
        if out["u_pdf"] is None:
            out["u_pdf"] = torch.rand(Bg, s.n_importance, generator=gen, device=dev)[rows]
        if out["noise_fine"] is None and getattr(state.field, "sigma_noise", False):
            out["noise_fine"] = noise(s.n_samples + s.n_importance)
    return out


def _reduce_grads(state: TrainState) -> None:
    """Average every gradient over the world: one all_reduce per parameter,
    in the fields' parameter order (the table's, whole, in both table
    modes)."""
    from nerfjax_torch.parallel import all_reduce_sum_

    world = state.mesh.world
    for p in (p for f in state.fields() for p in f.parameters()):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        all_reduce_sum_(p.grad)
        if world > 1:
            p.grad.div_(world)


def step_gradients(state: TrainState, batch: Mapping[str, torch.Tensor], *, u_strat=None, u_pdf=None,
                   occ_jitter=None, noise_coarse=None, noise_fine=None):
    """The first half of a step: the table gathered (``shard_hash_table``),
    the generator reseeded, the occupancy update, render, loss and
    backward, leaving each parameter's (this rank's) gradient. Returns
    (total, aux) of ``loss_fn``."""
    s = state.settings
    if state.shard is not None:
        state.shard.gather()
    state.generator.manual_seed(state.seed * 1_000_003 + state.step)
    if s.use_occupancy:
        with tracing.span("train.occupancy"):
            update_occupancy(state, jitter=occ_jitter)
    draws = {"u_strat": u_strat, "u_pdf": u_pdf, "noise_coarse": noise_coarse, "noise_fine": noise_fine}
    if state.mesh is not None and state.mesh.world > 1:
        draws = _global_draws(state, batch["rays_o"].shape[0], draws)
    with tracing.span("train.forward"):
        total, aux = loss_fn(state.field, batch, s, state.occ_grid, field_coarse=state.field_coarse,
                             generator=state.generator, **draws)
    with tracing.span("train.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
    return total, aux


def apply_gradients(state: TrainState) -> None:
    """The second half of a step: the gradients averaged over the world,
    the global-norm clip, the table's gradient cut to this rank's slice
    (``shard_hash_table``), AdamW and the schedule."""
    if _collective(state):
        _reduce_grads(state)
    if state.settings.grad_clip is not None:
        clip_by_global_norm_([p for f in state.fields() for p in f.parameters()], float(state.settings.grad_clip))
    if state.shard is not None:
        state.shard.take_grad()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor], *, u_strat=None, u_pdf=None,
               occ_jitter=None, noise_coarse=None, noise_fine=None) -> dict:
    """One step on a batch of tensors on the field's device: occupancy
    update (every update_every steps, with the grid on), render, loss,
    backward, AdamW (``step_gradients``, then ``apply_gradients``).
    ``u_strat``/``u_pdf`` (the render's), ``occ_jitter`` and vanilla's
    sigma noise ``noise_coarse``/``noise_fine`` override the generator's
    draws (the parity tests pass nerfjax's). Returns the step's metrics as
    0-d tensors (no host sync).

    With ``state.mesh`` over several ranks ``batch`` is this rank's block
    of the global batch and the overrides its rows; the gradients are
    averaged over the world and the metrics are those of the global batch."""
    with tracing.unit("train.step", state.step) as sp:
        sp.count("rays", batch["rays_o"].shape[0])
        total, aux = step_gradients(state, batch, u_strat=u_strat, u_pdf=u_pdf, occ_jitter=occ_jitter,
                                    noise_coarse=noise_coarse, noise_fine=noise_fine)
        with tracing.span("train.optimizer"):
            apply_gradients(state)
        metrics = {"loss_total": total.detach(), "loss_coarse": aux["loss_coarse"].detach(),
                   "loss_fine": aux["loss_fine"].detach(), "psnr": aux["psnr"].detach()}
        if state.mesh is not None and state.mesh.world > 1:
            from nerfjax_torch.parallel import all_reduce_sum_

            losses = all_reduce_sum_(torch.stack([metrics[k] for k in ("loss_total", "loss_coarse", "loss_fine")]))
            losses = losses / state.mesh.world
            metrics = {"loss_total": losses[0], "loss_coarse": losses[1], "loss_fine": losses[2],
                       "psnr": -10.0 * torch.log10(losses[2])}
    return metrics


def _set_step(state: TrainState, step: int) -> None:
    state.step = step
    state.scheduler.last_epoch = step
    for group in state.optimizer.param_groups:
        group["lr"] = onecycle_lr_host(state.settings, step)


def restore(state: TrainState, path, steps_per_epoch: int) -> int:
    """Resume ``state`` from a port checkpoint: field, AdamW, schedule, grid
    (when the state has one) and step count. Returns the checkpoint's
    epoch."""
    from nerfjax_torch import checkpoint as ckpt

    epoch = ckpt.restore_train_state(path, state.field, state.optimizer, field_coarse=state.field_coarse)
    _set_step(state, epoch * steps_per_epoch)
    if state.occ_grid is not None:
        grid = ckpt.load_occ_grid(path)
        if grid is not None and grid.shape == tuple(state.occ_grid.shape):
            state.occ_grid = torch.from_numpy(grid).to(state.occ_grid.device)
    return epoch


def _broadcast_restored(state: TrainState, epoch: int, steps_per_epoch: int) -> int:
    """Agree on rank 0's restored state: its epoch, then (if it restored
    one) the parameters, AdamW's moments and step counts, and the
    occupancy grid, each broadcast in place. A rank that read no checkpoint
    (its own checkpoint_dir may be empty) resumes all the same."""
    from nerfjax_torch.parallel import broadcast_, broadcast_object

    params = [p for f in state.fields() for p in f.parameters()]
    opt_params = [p for g in state.optimizer.param_groups for p in g["params"]]
    steps = [int(state.optimizer.state[p]["step"]) if state.optimizer.state.get(p) else 0 for p in opt_params]
    epoch, steps = broadcast_object([epoch, steps])
    if epoch == 0:
        return 0
    with torch.no_grad():
        for p in params:
            broadcast_(p.data)
        for p, step in zip(opt_params, steps):
            st = state.optimizer.state[p]
            if not st:
                st.update(step=torch.tensor(float(step)), exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
            broadcast_(st["exp_avg"])
            broadcast_(st["exp_avg_sq"])
        if state.occ_grid is not None:
            broadcast_(state.occ_grid)
    _set_step(state, epoch * steps_per_epoch)
    return epoch


def _optimizer_view(state: TrainState):
    """What ``checkpoint.save_train_state`` reads of the optimizer (its
    ``state``), with the table's whole moments under ``shard_hash_table``
    (every rank of the model axis joins)."""
    if state.shard is None:
        return state.optimizer
    import types

    view = dict(state.optimizer.state)
    view[state.field.table] = state.shard.moments(state.optimizer)
    return types.SimpleNamespace(state=view)


def table_optimizer_bytes(state: TrainState) -> int:
    """Bytes of the hash table's AdamW moments this rank holds (0 for vanilla)."""
    table = state.shard.param if state.shard is not None else getattr(state.field, "table", None)
    st = state.optimizer.state.get(table) if table is not None else None
    if st:
        return sum(st[k].numel() * st[k].element_size() for k in ("exp_avg", "exp_avg_sq"))
    return 0 if table is None else 2 * table.numel() * table.element_size()


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
    "psnr" (every step's), "total_time", "rays_per_sec", "steps", "rank",
    "world", "table_optimizer_bytes" (this rank's)}. Writes TensorBoard
    scalars under ``output_dir/logs``, ``nerf_epoch_{E:06d}.pth`` every
    second epoch and ``nerf_final.pth`` under ``checkpoint_dir``. With
    ``profile_dir`` (rank 0) it writes the run's ``torch.profiler`` trace
    (``trace.json``) and the program's spans (``spans.json``: ns since the
    epoch, each span's parent, unit id and counts; ``nerfjax_torch.tracing``).

    Over several ranks (``parallel.init_distributed`` first) every rank
    calls it with the same cfg and seed; ``batch_size`` is the global
    batch. Rank 0 alone writes files and prints."""
    from nerfjax_torch import checkpoint as ckpt
    from nerfjax_torch.data import RayDataset, prefetch_to_device
    from nerfjax_torch.extract import resolve_device
    from nerfjax_torch.logging_utils import Logger
    from nerfjax_torch.parallel import make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh_shape = cfg.get("mesh_shape", None)
    mesh = make_mesh(shape=tuple(int(v) for v in mesh_shape) if mesh_shape is not None else None)
    is_lead = mesh.rank == 0
    output_dir, checkpoint_dir = Path(cfg["output_dir"]), Path(cfg["checkpoint_dir"])
    if is_lead:
        output_dir.mkdir(parents=True, exist_ok=True)
        checkpoint_dir.mkdir(parents=True, exist_ok=True)
    dataset = RayDataset(cfg["rays_file"], use_memmap=bool(cfg.get("use_memmap", False)), verbose=is_lead)
    batch_size, num_epochs = int(cfg["batch_size"]), int(cfg["num_epochs"])
    steps_per_epoch = dataset.steps_per_epoch(batch_size)
    settings = TrainSettings.from_cfg(cfg, num_epochs * steps_per_epoch)
    state = make_train_state(cfg, settings, seed=seed, device=dev)
    state.mesh = mesh
    logger = Logger(output_dir / "logs") if is_lead else None

    start_epoch = 1
    if resume:
        # only the lead reads: it alone writes, so other ranks may not see the files
        latest = ckpt.latest_checkpoint(checkpoint_dir) if is_lead else None
        epoch = restore(state, latest, steps_per_epoch) if latest is not None else 0
        if dist.is_initialized():
            epoch = _broadcast_restored(state, epoch, steps_per_epoch)
        if epoch > 0:
            start_epoch = epoch + 1
            if is_lead:
                print(f"Resumed from {latest} at epoch {epoch}")
    if settings.shard_hash_table:
        shard_table(state)
    n_params = sum(p.numel() for f in state.fields() for p in f.parameters())
    table_bytes = table_optimizer_bytes(state)
    if is_lead:
        print(f"NERF: {n_params * 1e-6:.3f}M")
        print(f"Device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")
              + f", {mesh.world} process(es), mesh {'x'.join(map(str, mesh.shape))} {mesh.axis_names}")
        if state.shard is not None:
            print(f"Hash table split over {mesh.table_size} rank(s): its AdamW moments {table_bytes:,} B per rank")
        print(f"White background: {settings.white_bg}")
        print(f"Starting training for {num_epochs} epochs")
        print(f"Total steps: {settings.total_steps}")

    def save(path: Path, epoch: int) -> None:
        if state.shard is not None:  # every rank joins the gathers
            state.shard.gather()
        opt = _optimizer_view(state)
        if is_lead:
            ckpt.save_train_state(path, cfg, state.field, opt, epoch, occ_grid=state.occ_grid,
                                  field_coarse=state.field_coarse)

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=acts) if profile_dir and is_lead else contextlib.nullcontext()
    start_time = time.time()
    rays_done = 0
    metrics_host: dict = {}
    psnr_steps: list[torch.Tensor] = []
    with profiler:
        if profile_dir and is_lead:
            tracing.clear()  # this session's spans only
        for epoch in range(start_epoch, num_epochs + 1):
            batches = dataset.epoch_batches(batch_size, seed=seed * 100003 + epoch, process_index=mesh.rank,
                                            process_count=mesh.world)
            for idx, batch in enumerate(prefetch_to_device(batches, dev)):
                metrics = train_step(state, batch)
                psnr_steps.append(metrics["psnr"])
                rays_done += batch_size
                if idx % log_every == 0 and is_lead:
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
                save(path, epoch)
                if is_lead:
                    print(f"Saved checkpoint to {path}")
    if profile_dir and is_lead:
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
        tracing.write_json(Path(profile_dir) / "spans.json")

    final_path = checkpoint_dir / "nerf_final.pth"
    save(final_path, num_epochs)
    if dist.is_initialized() and mesh.world > 1 and state.occ_grid is not None:
        from nerfjax_torch.parallel import broadcast_

        if not torch.equal(broadcast_(state.occ_grid.clone()), state.occ_grid):
            raise RuntimeError(f"rank {mesh.rank}: the occupancy grid differs from rank 0's")
    total_time = time.time() - start_time
    if is_lead:
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
        "rank": mesh.rank,
        "world": mesh.world,
        "table_optimizer_bytes": table_bytes,
    }
