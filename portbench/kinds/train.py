"""Training traffic: ``train.train``'s inner loop on the benchmark's rays.

Set-up writes the seed's ray NPZ to ``TMPDIR`` and reads it through
``RayDataset`` as users' NPZs are read, builds one ``TrainState`` with the
benchmark's weights loaded (NGP: a field that holds a seeded sphere), and drives it through ``warmup_steps`` steps of
the window's own call and feed (``epoch_batches`` -> ``prefetch_to_device``
-> ``train_step`` with the benchmark's draws); the first ``check_steps``
steps are the ones the reference follows. The window then steps the same
state on: dispatched ahead, the step's metrics read on the host every
``log_every`` steps, a ``synchronize`` at its end, no checkpoint writes.

The check (after the window, the program's state freed): the first
step's loss, each leaf's first gradient (from AdamW's first moment after
step 1: 0.1 g) and each leaf's change after the checked steps, against
the reference's (``numbers``; the cell's limits file names the ones it
compares). A traced run also counts the table entries the reference's
first step touches, for the hash-grid bound.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench import traffic as gen
from portbench import work
from portbench.reference import train as ref
from portbench.reference.precision import no_tf32

BETA1 = 0.9


def _flat_params(state) -> dict:
    if state.field_coarse is None:
        return ref.flatten(state.field.params())
    return ref.flatten({"coarse": state.field_coarse.params(), "fine": state.field.params()})


def _init(run):
    """NGP: the field that holds the seed's sphere (``traffic.sphere_field``),
    so that no ray's color hangs on its last sample's alpha, as it does at
    tcnn's init; vanilla: torch.nn.Linear's init."""
    if run.cfg.get("ngp", True):
        return gen.sphere_field(run.cfg, run.seed, run.traffic["field"], run.device)
    return gen.vanilla_init(run.cfg, run.seed, run.device)


def _load(state, params: dict) -> None:
    if state.field_coarse is None:
        state.field.load_params(params)
    else:
        state.field_coarse.load_params(params["coarse"])
        state.field.load_params(params["fine"])


def setup(run) -> None:
    from nerfjax_torch import _build
    from nerfjax_torch.data import RayDataset, prefetch_to_device
    from nerfjax_torch.train import TrainSettings, make_train_state, train_step

    cfg, tr, dev = run.cfg, run.traffic, run.device
    if cfg.get("ngp", True) and dev.type == "cuda":
        _build.build_all(("hash_encode",))
        _build.load("hash_encode")
    run.mark("extensions")
    path = run.tmp / f"portbench_{run.cell}_rays.npz"
    np.savez(path, **gen.ball_rays(run.seed, int(cfg["train_rays"]), tr["scene"]))
    dataset = RayDataset(path, verbose=False)
    path.unlink()
    run.mark("data")
    B = int(cfg["batch_size"])
    settings = TrainSettings.from_cfg(cfg, int(cfg["num_epochs"]) * dataset.steps_per_epoch(B))
    state = make_train_state(cfg, settings, seed=run.seed & 0x7FFFFFFF, device=dev)
    params0 = _init(run)
    _load(state, params0)
    run.mark("program")

    n_check = int(tr["check_steps"])
    held: list[dict] = []

    def epoch_source(epoch: int):
        for batch in dataset.epoch_batches(B, seed=gen.seed64(run.seed, 5, epoch)):
            if len(held) < n_check:
                held.append(batch)
            yield batch

    def feed():
        epoch = 1
        while True:
            yield from prefetch_to_device(epoch_source(epoch), dev)
            epoch += 1

    noise = not cfg.get("ngp", True)
    S, I = settings.n_samples, settings.n_importance

    def draws(step: int) -> dict:
        return gen.step_draws(run.seed, step, B, S, I, noise, dev)

    leaves = _flat_params(state)
    p0 = ref.flatten(params0)
    out = {"loss": [], "draws": []}
    it = feed()
    for k in range(int(tr["warmup_steps"])):
        d = draws(k)
        metrics = train_step(state, next(it), **d)
        if k < n_check:
            out["loss"].append(metrics["loss_total"])
            out["draws"].append(d)
        if k == 0:
            opt = state.optimizer.state
            out["grad"] = {n: torch.linalg.vector_norm(opt[p]["exp_avg"]) / (1.0 - BETA1) if p in opt
                           else torch.zeros((), device=dev) for n, p in leaves.items()}
        if k == n_check - 1:
            out["change"] = {n: torch.linalg.vector_norm(p.detach() - p0[n]) for n, p in leaves.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.mark("warmup")
    run.extra.update(state=state, it=it, step=int(tr["warmup_steps"]), draws=draws, params0=params0,
                     held=held, settings=settings, dataset=dataset, train_step=train_step)
    run.outputs = out


def window(run, seconds: float) -> None:
    x, spans = run.extra, run.spans
    state, it, train_step, draws = x["state"], x["it"], x["train_step"], x["draws"]
    B, log_every = int(run.cfg["batch_size"]), int(run.traffic["log_every"])
    losses, ends = [], []
    steps = 0
    step = x["step"]
    t0 = time.perf_counter()
    while True:
        with spans.span("batch_wait"):
            batch = next(it)
        with spans.span("dispatch"):
            metrics = train_step(state, batch, **draws(step))
        losses.append(metrics["loss_total"])
        if step % log_every == 0:
            with spans.span("metrics_read"):
                float(metrics["loss_total"])
        step += 1
        steps += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter() - t0
    ends[-1] = t0 + t
    run.extra["unit_ends"] = (t0, ends)
    x["step"] = step
    run.attempted += steps
    run.failed += int((~torch.isfinite(torch.stack(losses))).sum())
    run.units.update(steps=steps, rays=steps * B, window_s=t)
    run.e2e["train_rays_per_s"] = steps * B / t


def _leaf_gaps(prog: dict, refn: dict, names) -> dict:
    """Each leaf's gap between the two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(refn[n] for n in names)
    return {n: abs(prog[n] - refn[n]) / max(refn[n], med) for n in names}


def numbers(prog: dict, refr: dict) -> dict:
    """Every number a training cell can compare (its limits file names those
    it does), the program side ``prog`` against the reference's ``refr``:

    loss_gap: the first step's loss (the later steps' swing: AdamW's first
    update moves every entry with a nonzero gradient by about lr whatever
    its size, and another rounding of the importance depths touches other
    table entries; see PERF.md);
    grad_gap / change_gap: the worst leaf's gap of the first gradient / of
    the change after the checked steps; grad_gap_median / change_gap_median:
    the lower median leaf's (the density MLP's gradient rests on the last
    sample's d alpha / d sigma = 1e10 exp(-1e10 sigma), which a rounding of
    a sigma near 1e-10 moves by orders); table_change_gap: the hash
    table's change. Leaves whose reference gradient is under a thousandth
    of the median leaf's are left out of the changes."""
    names = list(refr["grad"])
    med = statistics.median(refr["grad"][n] for n in names)
    moved = [n for n in names if refr["grad"][n] >= 1e-3 * med]
    grad, change = _leaf_gaps(prog["grad"], refr["grad"], names), _leaf_gaps(prog["change"], refr["change"], moved)
    out = {"loss_gap": abs(prog["loss"][0] - refr["loss"][0]) / abs(refr["loss"][0]),
           "grad_gap": max(grad.values()), "grad_gap_median": statistics.median_low(grad.values()),
           "change_gap": max(change.values()) if change else 0.0,
           "change_gap_median": statistics.median_low(change.values()) if change else 0.0}
    if "table" in change:
        out["table_change_gap"] = change["table"]
    return out, {"grad_gaps": grad, "change_gaps": change}


def check(run) -> None:
    x = run.extra
    out = run.outputs
    prog = {"loss": [float(v) for v in out["loss"]], "grad": {n: float(v) for n, v in out["grad"].items()},
            "change": {n: float(v) for n, v in out["change"].items()}}
    for key in ("state", "it", "dataset", "train_step"):
        x.pop(key, None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    dev = run.device
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in x["held"]]
    total = x["settings"].total_steps
    refr = ref.steps(run.cfg, x["params0"], batches, out["draws"], total, "f32")
    if run.mode == "control":
        prog = ref.steps(run.cfg, x["params0"], batches, out["draws"], total, "fp8")
    if run.traced and run.cfg.get("ngp", True):  # the hash-grid bound's table entries, a step's passes
        b = batches[0]
        run.extra["entries"] = tuple(
            work.distinct_entries(run.cfg, (b["rays_o"][:, None] + b["rays_d"][:, None] * z[..., None]).reshape(-1, 3))
            for z in refr["depths"])
    run.extra["readings"] = {"program": prog, "reference": refr}
    values, leaves = numbers(prog, refr)
    run.extra["notes"] = {"numbers": values, **leaves,
                          "loss_gap_by_step": [abs(p - r) / abs(r) for p, r in zip(prog["loss"], refr["loss"])]}
    run.checks += [(name, value, float(run.limits[name])) for name, value in values.items() if name in run.limits]
