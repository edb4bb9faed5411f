"""The plain reference against nerfjax_torch at a tiny size on the CPU."""

import json

import numpy as np
import torch

from pb_helpers import ROOT, SEED
from portbench import traffic
from portbench.reference import fields, render, train
from portbench.reference.extract import dilate, extract, otsu

NGP = {**json.loads((ROOT / "portbench/configs/ngp_dropin.json").read_text()),
       "nerf_type": "small", "hash_n_levels": 8, "precision": "fp32"}
VAN = {**json.loads((ROOT / "portbench/configs/nerf_vanilla.json").read_text()), "hidden_dim": 32,
       "precision": "fp32"}


def _bf16_exact(t):
    return t.to(torch.bfloat16).to(torch.float32)


def test_hash_encode_matches_the_program():
    from nerfjax_torch.fields.ngp import HashGridSpec
    from nerfjax_torch.ops.hash_encode import hash_encode_planar

    spec = HashGridSpec(n_levels=8, log2_hashmap_size=15)
    g = torch.Generator().manual_seed(0)
    table = _bf16_exact(torch.rand(2, spec.total_table_size, generator=g) * 2 - 1)  # the hashed levels read bf16
    x = torch.rand(3000, 3, generator=g)
    x[0], x[1] = 0.0, 1.0
    got = hash_encode_planar(spec, table, *x.T.contiguous(), dtype=torch.float32).T
    want = fields.hash_encode(table, x, fields.level_table(8, 15))
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


def test_fields_match_the_program():
    from nerfjax_torch.train import build_fields

    g = torch.Generator().manual_seed(1)
    pos, view = torch.rand(500, 3, generator=g) * 2 - 1, torch.nn.functional.normalize(torch.randn(500, 3), dim=1)
    p = traffic.ngp_init(NGP, SEED, "cpu")
    p["table"] = _bf16_exact(p["table"] * 1e3)
    field = build_fields(NGP)[1].load_params(p)
    rgb, sigma = field.apply_planar(tuple(pos.T), tuple(view.T), dtype=torch.float32)
    r_rgb, r_sigma = fields.ngp_apply(p, pos, view, train.ngp_levels(NGP))
    assert torch.allclose(rgb.T, r_rgb, atol=1e-5) and torch.allclose(sigma, r_sigma, atol=1e-5)
    v = traffic.vanilla_init(VAN, SEED, "cpu")
    coarse = build_fields(VAN)[0].load_params(v["coarse"])
    noise = torch.randn(500)
    rgb, sigma = coarse.apply_planar(tuple(pos.T), tuple(view.T), dtype=torch.float32, train=True, noise=noise)
    r_rgb, r_sigma = fields.vanilla_apply(v["coarse"], pos, view, VAN, noise)
    assert torch.allclose(rgb.T, r_rgb, atol=1e-5) and torch.allclose(sigma, r_sigma, atol=1e-4)


def test_first_training_step_matches_the_program():
    from nerfjax_torch.train import TrainSettings, make_train_state, train_step

    for cfg, init in ((VAN, traffic.vanilla_init), (NGP, traffic.ngp_init)):
        rays = traffic.ball_rays(SEED, 64, json.loads((ROOT / "portbench/workloads/ball_rays.json").read_text())["scene"])
        batch = {"rays_o": rays["rays_o"], "rays_d": rays["rays_d"], "rgb": rays["rgbs"], "t_near": rays["t_near"],
                 "t_far": rays["t_far"]}
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        s = TrainSettings.from_cfg(cfg, 100)
        st = make_train_state(cfg, s, seed=0, device="cpu")
        p0 = init(cfg, SEED, "cpu")
        for f, part in zip(st.fields(), [p0["coarse"], p0["fine"]] if "coarse" in p0 else [p0]):
            f.load_params(part)
        d = traffic.step_draws(SEED, 0, 64, 64, 128, "coarse" in p0, "cpu")
        m = train_step(st, batch, **d)
        ref = train.steps(cfg, p0, [batch], [d], 100)
        assert abs(float(m["loss_total"]) - ref["loss"][0]) < 1e-5 * ref["loss"][0]
        flat = train.flatten({"coarse": st.field_coarse.params(), "fine": st.field.params()} if "coarse" in p0
                             else st.field.params())
        for name, p in flat.items():
            g = float(torch.linalg.vector_norm(st.optimizer.state[p]["exp_avg"])) / 0.1
            assert abs(g - ref["grad"][name]) <= 2e-2 * max(ref["grad"][name], 1e-12), name


def test_frame_rays_equal_the_programs_bit_for_bit():
    from nerfjax_torch.rays import get_rays, ray_cube_intersection

    K = traffic.intrinsics(40, 30, 0.6911112)
    c2w = traffic.orbit_poses(SEED, 3, 4.03, 30.0)[1]
    ro, rd = get_rays(40, 30, K, torch.from_numpy(c2w)[None])
    hit, tn, tf = ray_cube_intersection(ro.reshape(-1, 3), rd.reshape(-1, 3))
    idx, o, d, n, f = traffic.frame_rays(40, 30, K, c2w, "cpu")
    assert torch.equal(idx, torch.nonzero(hit).squeeze(1))
    assert torch.equal(d, rd.reshape(-1, 3)[idx]) and torch.equal(n, tn[idx]) and torch.equal(f, tf[idx])


def test_sampling_and_compositing_match_the_program():
    from nerfjax_torch import render as prog

    g = torch.Generator().manual_seed(2)
    near, far = torch.rand(50, generator=g), 2 + torch.rand(50, generator=g)
    u = torch.rand(50, 16, generator=g)
    assert torch.equal(render.stratified_z(near, far, 16, u), prog.stratified_z(near, far, 16, u))
    rgb, sigma = torch.rand(50, 16, 3, generator=g), torch.rand(50, 16, generator=g) * 5
    z = prog.stratified_z(near, far, 16, u)
    a = prog.raw2outputs_planar(rgb.permute(2, 0, 1), sigma, z)
    b = render.composite(rgb, sigma, z)
    assert all(torch.allclose(x, y, atol=1e-6) for x, y in zip(a, b))
    w, up = torch.rand(50, 15, generator=g), torch.rand(50, 32, generator=g)
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    assert torch.allclose(render.sample_pdf(bins, w[:, :-1], up), prog.sample_pdf(bins, w[:, :-1], 32, u=up),
                          atol=1e-4)


def test_otsu_dilation_and_extraction_match_the_program():
    from nerfjax_torch.extract import _dilate_mask, extract_volume
    from nerfjax_torch.ops.otsu import otsu_threshold

    v = torch.rand(20000, generator=torch.Generator().manual_seed(3)) ** 3
    assert otsu(v) == float(otsu_threshold(v))
    m = torch.rand(9, 9, 9) > 0.9
    assert np.array_equal(dilate(m).numpy(), _dilate_mask(m.numpy()))
    cfg = {**NGP}
    p = traffic.sphere_field(cfg, SEED, {"radius": 0.5, "center_range": 0.1, "gain": 40.0}, "cpu")
    got = extract_volume(cfg, params={"model": p}, resolution=128, device="cpu", dtype=torch.float32, verbose=False)
    want = extract(cfg, p, 128)
    occ = torch.from_numpy(got["occupancy_volume"]).reshape(-1)
    assert float((occ != want["occupancy"]).sum()) <= 1e-3 * float(want["occupancy"].sum())
    assert abs(got["metadata"]["threshold"] - want["threshold"]) <= 1e-3 * abs(want["threshold"])
