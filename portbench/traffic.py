"""The one generator of the benchmark's inputs, driven by a workload file's
parameters and ``--seed``: the training rays (a ball scene), the weights
(tcnn's / torch.nn.Linear's init, or a field that holds a sphere), the
held-out camera poses, each step's or chunk's uniforms, and a frame's
pixel rays (frozen from the program's ``get_rays`` and
``ray_cube_intersection``, which give the same bits on every device).
The same seed gives the same inputs; different seeds give the same amount
of work (the sizes are the workload's, only positions and values move)."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.fields import ngp_levels

MASK63 = (1 << 63) - 1


def seed64(*parts: int) -> int:
    """A torch seed from integers (any size, any sign)."""
    h = 1469598103934665603
    for p in parts:
        h = ((h ^ (int(p) & MASK63)) * 1099511628211) & MASK63
    return h


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & MASK63, stream])


# -- training rays ---------------------------------------------------------


def ball_rays(seed: int, n: int, scene: dict) -> dict[str, np.ndarray]:
    """n rays from ``cameras`` cameras on a sphere of radius ``camera_radius``
    around a ball of radius ``radius``, density ``sigma`` and color ``rgb``
    on black, each aimed at a uniform point of [-aim, aim]^3; the color is
    exact volume rendering of the ball. The ball's center (within
    ``center_range`` of the origin) and the cameras come from the seed.
    t_near / t_far clip each ray to the [-1, 1]^3 cube."""
    rng = host_rng(seed, 1)
    center = rng.uniform(-scene["center_range"], scene["center_range"], 3).astype(np.float32)
    cams = rng.normal(size=(int(scene["cameras"]), 3)).astype(np.float32)
    cams *= np.float32(scene["camera_radius"]) / np.linalg.norm(cams, axis=1, keepdims=True)
    o = cams[rng.integers(0, len(cams), n)]
    aim = np.float32(scene["aim"])
    d = rng.random((n, 3), dtype=np.float32) * (2 * aim) - aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    oc = o - center
    b = np.sum(oc * d, axis=1)
    disc = b * b - (np.sum(oc * oc, axis=1) - np.float32(scene["radius"]) ** 2)
    chord = 2.0 * np.sqrt(np.maximum(disc, 0.0))
    rgb = np.asarray(scene["rgb"], np.float32)[None, :] * (1.0 - np.exp(-np.float32(scene["sigma"]) * chord))[:, None]
    dd = np.where(np.abs(d) < 1e-8, np.float32(1e-8), d)
    t0, t1 = (-1 - o) / dd, (1 - o) / dd
    return {"rays_o": o, "rays_d": d, "rgbs": rgb.astype(np.float32),
            "t_near": np.maximum(np.minimum(t0, t1).max(1), 0.0).astype(np.float32),
            "t_far": np.maximum(t0, t1).min(1).astype(np.float32)}


def step_draws(seed: int, step: int, B: int, n_samples: int, n_importance: int, noise: bool, device) -> dict:
    """The uniforms (and vanilla's sigma noise) of one training step, on the
    device: u_strat [B, S], u_pdf [B, I], noise_coarse [B S], noise_fine
    [B (S + I)]."""
    g = torch.Generator(device=device).manual_seed(seed64(seed, 11, step))
    out = {"u_strat": torch.rand(B, n_samples, generator=g, device=device),
           "u_pdf": torch.rand(B, n_importance, generator=g, device=device)}
    if noise:
        out["noise_coarse"] = torch.randn(B * n_samples, generator=g, device=device)
        out["noise_fine"] = torch.randn(B * (n_samples + n_importance), generator=g, device=device)
    return out


def chunk_draws(seed: int, frame: int, start: int, B: int, n_samples: int, n_importance: int, device):
    """(u_strat [B, S], u_pdf [B, I]) of one render chunk."""
    g = torch.Generator(device=device).manual_seed(seed64(seed, 13, frame, start))
    return (torch.rand(B, n_samples, generator=g, device=device),
            torch.rand(B, n_importance, generator=g, device=device))


# -- weights ----------------------------------------------------------------


def _uniform(g, n: int, device) -> torch.Tensor:
    return torch.rand(n, generator=g, device=device) * 2.0 - 1.0


def ngp_dims(cfg: dict) -> dict:
    E = 2 * int(cfg.get("hash_n_levels", 16))
    return {"dmlp": [(E, 64), (64, 16)], "cmlp": [(32, 64), (64, 64), (64, 3)]}


def ngp_init(cfg: dict, seed: int, device) -> dict:
    """tcnn's init on the device: the [2, total] table uniform in +-1e-4,
    each MLP weight uniform in +-sqrt(6 / (in + out)); two draws."""
    g = torch.Generator(device=device).manual_seed(seed64(seed, 21))
    lv = ngp_levels(cfg)
    total = lv[-1]["offset"] + lv[-1]["size"]
    table = _uniform(g, 2 * total, device).reshape(2, total) * 1e-4
    dims = ngp_dims(cfg)
    flat = _uniform(g, sum(i * o for layers in dims.values() for i, o in layers), device)
    out, at = {"table": table}, 0
    for name, layers in dims.items():
        out[name] = []
        for i, o in layers:
            out[name].append({"w": flat[at : at + i * o].reshape(i, o) * math.sqrt(6.0 / (i + o))})
            at += i * o
    return out


def sphere_field(cfg: dict, seed: int, field: dict, device) -> dict:
    """An NGP field that holds a sphere: ``ngp_init``, then plane 0 of every
    dense level set to the signed distance of its lattice points to a sphere
    of radius ``field["radius"]`` (center within ``center_range``, from the
    seed), the first density unit the mean of those levels, and sigma =
    ``gain`` * that unit inside the sphere."""
    p = ngp_init(cfg, seed, device)
    center = host_rng(seed, 2).uniform(-field["center_range"], field["center_range"], 3)
    dense = [lv for lv in ngp_levels(cfg) if not lv["hashed"]]
    for lv in dense:
        r = lv["res"]
        c = 2.0 * (torch.arange(r, dtype=torch.float64, device=device) - 0.5) / lv["scale"] - 1.0
        z, y, x = torch.meshgrid(c, c, c, indexing="ij")  # flat index x + y r + z r^2
        d = field["radius"] - torch.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2)
        p["table"][0, lv["offset"] : lv["offset"] + r**3] = d.reshape(-1).to(torch.float32)
    w1, w2 = p["dmlp"][0]["w"], p["dmlp"][1]["w"]
    w1[:, 0] = 0.0
    w1[: len(dense), 0] = 1.0 / len(dense)
    w2[:, 0] = 0.0
    w2[0, 0] = float(field["gain"])
    return p


def vanilla_init(cfg: dict, seed: int, device) -> dict:
    """torch.nn.Linear's init for both MLPs (w, b uniform in +-1/sqrt(in)),
    the density heads' w 0.01 N(0, 1) and b 0.1; two draws."""
    h, pd = int(cfg.get("hidden_dim", 256)), 3 + 6 * int(cfg.get("pos_L", 10))
    dd = 3 + 6 * int(cfg.get("dir_L", 4))
    shapes = {"pos_layers": [(pd if i == 0 else h, h) for i in range(4)],
              "skip_layers": [(h + pd if i == 0 else h, h) for i in range(4)],
              "density": (h, 1), "feature": (h, h), "color_layers": [(h + dd, h // 2), (h // 2, 3)]}
    g = torch.Generator(device=device).manual_seed(seed64(seed, 22))
    total = sum(i * o + o for v in shapes.values() for i, o in (v if isinstance(v, list) else [v]))
    flat = _uniform(g, 2 * total, device)
    dens = torch.randn(2 * h, generator=g, device=device) * 0.01
    at, out = 0, {}
    for f, which in enumerate(("coarse", "fine")):
        net = {}
        for name, v in shapes.items():
            layers = []
            for i, o in v if isinstance(v, list) else [v]:
                bound = 1.0 / math.sqrt(i)
                w, b = flat[at : at + i * o].reshape(i, o) * bound, flat[at + i * o : at + i * o + o] * bound
                at += i * o + o
                if name == "density":
                    w, b = dens[f * h : (f + 1) * h].reshape(h, 1), torch.full((1,), 0.1, device=device)
                layers.append({"w": w, "b": b})
            net[name] = layers if isinstance(v, list) else layers[0]
        out[which] = net
    return out


# -- held-out frames -----------------------------------------------------------


def orbit_poses(seed: int, n: int, radius: float, elevation_deg: float) -> np.ndarray:
    """[n, 4, 4] OpenGL camera-to-world poses evenly spaced on a circle of
    ``radius`` at ``elevation_deg``, looking at the origin (+Z up); the
    circle's starting angle comes from the seed."""
    phase = host_rng(seed, 3).uniform(0.0, 2.0 * np.pi)
    el = np.deg2rad(elevation_deg)
    poses = np.empty((n, 4, 4), np.float32)
    for i in range(n):
        a = phase + 2.0 * np.pi * i / n
        cam = radius * np.array([np.cos(el) * np.cos(a), np.cos(el) * np.sin(a), np.sin(el)])
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, cam
        poses[i] = c2w
    return poses


def intrinsics(H: int, W: int, camera_angle_x: float) -> np.ndarray:
    f = 0.5 * W / np.tan(0.5 * camera_angle_x)
    return np.array([[f, 0.0, 0.5 * W], [0.0, f, 0.5 * H], [0.0, 0.0, 1.0]], np.float32)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    return (a.double() / torch.as_tensor(b, dtype=torch.float64, device=a.device)).float()


def _fma_chain(pairs) -> torch.Tensor:
    acc = None
    for a, b in pairs:
        p = a.double() * b.double()
        acc = (p if acc is None else p + acc.double()).float()
    return acc


def frame_rays(H: int, W: int, K: np.ndarray, c2w: np.ndarray, device):
    """The frame's rays that hit the [-1, 1]^3 cube, in pixel order:
    (pixel index [n] int64, rays_o, rays_d [n, 3], t_near, t_far [n])."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    K_inv = torch.linalg.inv(torch.as_tensor(K, dtype=torch.float32)).to(device)
    u = torch.arange(W, dtype=torch.float32, device=device)
    v = torch.arange(H, dtype=torch.float32, device=device)
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    pix = torch.stack([uu.reshape(-1), vv.reshape(-1), torch.ones(H * W, dtype=torch.float32, device=device)])
    dirs = _fma_chain((K_inv[:, j, None], pix[j]) for j in range(3))
    dirs = dirs * torch.tensor([1.0, -1.0, -1.0], device=device)[:, None]
    dirs = _div(dirs, _fma_chain((d, d) for d in dirs).double().sqrt().float().clamp_min(1e-8))
    rd = _fma_chain((c2w[:3, j, None], dirs[j]) for j in range(3)).T.contiguous()
    ro = c2w[None, :3, 3].expand(rd.shape)
    eps = 1e-8
    d = torch.where(rd.abs() < eps, torch.sign(rd) * eps, rd)
    d = torch.where(d == 0.0, torch.full_like(d, eps), d)
    t0, t1 = _div(-1.0 - ro, d), _div(1.0 - ro, d)
    tn, tf = torch.minimum(t0, t1).amax(dim=-1), torch.maximum(t0, t1).amin(dim=-1)
    hit = (tn <= tf) & (tf >= 0.0)
    idx = torch.nonzero(hit).squeeze(1)
    return idx, ro[idx], rd[idx], tn.clamp_min(0.0)[idx], tf[idx]
