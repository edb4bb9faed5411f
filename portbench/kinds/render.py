"""Held-out rendering traffic: ``render_image.render_image`` frame after
frame on a seeded orbit of poses, each frame brought to the host as the
function returns it, on a field that holds a seeded sphere.

Set-up builds the field with the benchmark's weights, the poses and the
intrinsics, counts each pose's rays that hit the cube (the work counts'
input), and renders one frame. Each chunk's uniforms come from the
benchmark (``render_image``'s ``draws`` hook), so the reference draws the
same. The check renders ``check_frames`` frames of the window, drawn from
the seed, with the reference, and compares the RMS of the pixel gap; a
traced run also counts the table entries the first of them touches, for
the hash-grid bound."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import traffic as gen
from portbench import work
from portbench.reference.precision import no_tf32
from portbench.reference.render import render_rays
from portbench.reference.train import field_fns


ENTRY_EVERY = 4  # the hash-grid bound counts table entries on every 4th chunk of the checked frame


def _frame_args(run):
    tr, cfg = run.traffic, run.cfg
    H, W = tr["frame"]
    return H, W, int(cfg.get("N_samples", 64)), int(cfg.get("N_importance", 128)), int(tr["chunk_rays"])


def setup(run) -> None:
    from nerfjax_torch import _build
    from nerfjax_torch.render_image import render_image
    from nerfjax_torch.train import build_fields

    cfg, tr, dev = run.cfg, run.traffic, run.device
    if dev.type == "cuda":
        _build.build_all(("hash_encode", "fused_mlp"))
        _build.load("hash_encode")
        _build.load("fused_mlp")
    run.mark("extensions")
    params = gen.sphere_field(cfg, run.seed, tr["field"], dev)
    H, W, S, I, chunk = _frame_args(run)
    poses = gen.orbit_poses(run.seed, int(tr["orbit"]), float(tr["camera_radius"]), float(tr["elevation_deg"]))
    K = gen.intrinsics(H, W, float(tr["camera_angle_x"]))
    hits = [int(gen.frame_rays(H, W, K, c2w, dev)[0].numel()) for c2w in poses]
    run.mark("data")
    field = build_fields(cfg, device=dev)[1]
    field.load_params(params)
    run.mark("program")

    def frame(i: int) -> np.ndarray:
        def hook(s, B):
            return gen.chunk_draws(run.seed, i, s, B, S, I, dev)

        return render_image(field, K, poses[i % len(poses)], H, W, n_samples=S, n_importance=I,
                            chunk_rays=chunk, dtype=torch.bfloat16, draws=hook)

    frame(-1)
    run.mark("warmup")
    run.extra.update(field=field, frame=frame, params=params, poses=poses, K=K, hits=hits, frames=[], next=0)


def window(run, seconds: float) -> None:
    x = run.extra
    H, W = run.traffic["frame"]
    done, ends = [], []
    t0 = time.perf_counter()
    while True:
        i = x["next"]
        with run.spans.span("frame"):
            img = x["frame"](i)
        x["next"] += 1
        done.append(i)
        x["frames"].append((i, img))
        run.attempted += 1
        run.failed += int(not np.isfinite(img).all())
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    t = ends[-1] - t0
    run.extra["unit_ends"] = (t0, ends)
    hit = sum(x["hits"][i % len(x["hits"])] for i in done)
    run.units.update(frames=len(done), pixels=len(done) * H * W, hit_rays=hit, window_s=t)
    run.e2e["render_rays_per_s"] = len(done) * H * W / t


def reference_frame(run, i: int, prec: str, entries: list | None = None) -> torch.Tensor:
    """Frame i of the window as the reference renders it: the same rays,
    padded and chunked as ``render_image`` chunks them, the same uniforms.
    ``entries``, if given, collects (distinct table entries, rays) of every
    ``ENTRY_EVERY``-th chunk: the entries its coarse and its fine pass
    touch, counted apart, and the frame's rays in it."""
    x, dev = run.extra, run.device
    H, W, S, I, chunk = _frame_args(run)
    idx, ro, rd, tn, tf = gen.frame_rays(H, W, x["K"], x["poses"][i % len(x["poses"])], dev)
    n = idx.numel()
    pad = -(-n // chunk) * chunk - n
    ro, rd, tn, tf = (torch.cat([a, a[:1].expand(pad, *a.shape[1:])]) for a in (ro, rd, tn, tf))
    field, _ = field_fns(run.cfg, x["params"], prec)
    out = torch.zeros(H * W, 3, device=dev)
    parts = []
    with torch.no_grad():
        for s in range(0, n + pad, chunk):
            u_s, u_p = gen.chunk_draws(run.seed, i, s, chunk, S, I, dev)
            r = render_rays(field, field, ro[s : s + chunk], rd[s : s + chunk], tn[s : s + chunk],
                            tf[s : s + chunk], u_s, u_p)
            parts.append(r["rgb_fine"])
            if entries is not None and (s // chunk) % ENTRY_EVERY == 0:
                touched = sum(work.distinct_entries(run.cfg, (ro[s : s + chunk, None] + rd[s : s + chunk, None]
                                                              * z[..., None]).reshape(-1, 3))
                              for z in (r["z_coarse"], r["z_fine"]))
                entries.append((touched, min(chunk, n - s)))
    out[idx] = torch.cat(parts)[:n]
    return out.reshape(H, W, 3)


def check(run) -> None:
    x = run.extra
    x.pop("field", None)
    x.pop("frame", None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    frames = x["frames"]
    n = min(int(run.traffic["check_frames"]), len(frames))
    picks = gen.host_rng(run.seed, 4).choice(len(frames), n, replace=False)
    worst = 0.0
    for n_pick, k in enumerate(picks):
        i, img = frames[int(k)]
        entries = [] if run.traced and n_pick == 0 else None
        refr = reference_frame(run, i, "f32", entries)
        if entries is not None:
            run.extra["entries_per_ray"] = sum(e for e, _ in entries) / sum(r for _, r in entries)
        prog = torch.from_numpy(img).to(run.device) if run.mode == "program" else reference_frame(run, i, "fp8")
        worst = max(worst, float(torch.sqrt(torch.mean((prog - refr) ** 2))))
    run.extra["notes"] = {"numbers": {"frame_rms": worst}}
    if "frame_rms" in run.limits:
        run.checks.append(("frame_rms", worst, float(run.limits["frame_rms"])))
