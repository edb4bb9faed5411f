"""The first training steps, plain: the two-pass render of each batch, the
MSE of the coarse and the fine colors, autograd's gradient, and AdamW
(Loshchilov & Hutter 2019: betas 0.9 / 0.999, eps 1e-8, decoupled weight
decay) at the OneCycle cosine learning rate (peak 10 lr after 10 % of the
steps, start peak / 10, end start / 100; Smith & Topin 2017, as optax's
``cosine_onecycle_schedule``). Float32, or the control's fp8 operands."""

from __future__ import annotations

import math

import torch

from portbench.reference.fields import ngp_apply, ngp_levels, vanilla_apply
from portbench.reference.render import render_rays


def flatten(tree, prefix: str = "") -> dict:
    """{dotted name: tensor} of a nested dict / list of tensors, in order."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_like(tree, flat: dict, prefix: str = ""):
    """``tree``'s nesting with the tensors of ``flat``."""
    if isinstance(tree, torch.Tensor):
        return flat[prefix]
    if isinstance(tree, dict):
        return {k: unflatten_like(v, flat, f"{prefix}.{k}" if prefix else str(k)) for k, v in tree.items()}
    return [unflatten_like(v, flat, f"{prefix}.{i}" if prefix else str(i)) for i, v in enumerate(tree)]


def field_fns(cfg: dict, params: dict, prec: str = "f32"):
    """(coarse, fine): (pos, view, noise) -> (rgb, sigma) of the config's model."""
    if cfg.get("ngp", True):
        levels = ngp_levels(cfg)

        def ngp(pos, view, noise):
            return ngp_apply(params, pos, view, levels, prec)

        return ngp, ngp

    def vanilla(which):
        return lambda pos, view, noise: vanilla_apply(params[which], pos, view, cfg, noise, prec)

    return vanilla("coarse"), vanilla("fine")


def onecycle_lr(lr: float, total_steps: int, count: int) -> float:
    if total_steps < 10:
        return lr
    peak, init = 10.0 * lr, lr
    final = init / 100.0
    b1 = int(0.1 * total_steps)
    if count >= total_steps:
        return final

    def interp(a, b, pct):
        return b + 0.5 * (a - b) * (math.cos(math.pi * pct) + 1.0)

    if count < b1:
        return interp(init, peak, count / b1)
    return interp(peak, final, (count - b1) / (total_steps - b1))


def steps(cfg: dict, params0: dict, batches: list, draws: list, total_steps: int, prec: str = "f32") -> dict:
    """Run len(batches) steps from ``params0`` (nested, float32; not
    modified). ``draws[i]``: {"u_strat", "u_pdf"[, "noise_coarse",
    "noise_fine"]}. Returns {"loss": [each step's],
    "grad": {leaf: norm of the first gradient}, "change": {leaf: norm of
    the parameters' change after the last step}, "depths": the first step's
    (z_coarse, z_fine)}."""
    lr, wd = float(cfg.get("lr", 5e-4)), float(cfg.get("weight_decay", 1e-6))
    b1, b2, eps = 0.9, 0.999, 1e-8
    p0 = flatten(params0)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    out = {"loss": [], "grad": {}, "change": {}}
    for i, (batch, d) in enumerate(zip(batches, draws)):
        coarse, fine = field_fns(cfg, unflatten_like(params0, leaves), prec)
        r = render_rays(coarse, fine, batch["rays_o"], batch["rays_d"], batch["t_near"], batch["t_far"],
                        d["u_strat"], d["u_pdf"], d.get("noise_coarse"), d.get("noise_fine"))
        target = batch["rgb"]
        loss = torch.mean((r["rgb_coarse"] - target) ** 2) + torch.mean((r["rgb_fine"] - target) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out["loss"].append(float(loss.detach()))
        if i == 0:
            out["depths"] = (r["z_coarse"], r["z_fine"])
        t = i + 1
        step_lr = onecycle_lr(lr, total_steps, i)
        with torch.no_grad():
            for (k, p), g in zip(leaves.items(), grads):
                if i == 0:
                    out["grad"][k] = float(torch.linalg.vector_norm(g))
                p.mul_(1.0 - step_lr * wd)
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1.0 - b2**t)).add_(eps)
                p.addcdiv_(m[k], denom, value=-step_lr / (1.0 - b1**t))
        del grads, loss, r
    with torch.no_grad():
        out["change"] = {k: float(torch.linalg.vector_norm(leaves[k] - p0[k])) for k in leaves}
    return out
