"""Several ranks of the port (nerfjax_torch.parallel, train(), extract_volume)
on the CPU over gloo: child processes on a free localhost port, each one
rank, at a tiny size (NGP small, 8 levels, batch 64, fp32, the exact
estimators, as tests/test_multihost.py).

Held: each rank's batch blocks equal nerfjax's; a step over W ranks equals
the one-rank step up to the order of summation (fp32 step bound: rtol
1e-4 with a floor of 1e-4 x the largest entry); shard_hash_table equals the
replicated table bit for bit; the extraction over two ranks equals the
world of one bit for bit; and the port's two-rank step equals nerfjax's
step over a two-device mesh (conftest's virtual CPU devices) within the
fp32 step bound, with the draws pinned.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfjax_torch import checkpoint as ckpt
from nerfjax_torch import extract as E
from nerfjax_torch import train as T
from nerfjax_torch.parallel import distributed as D
from nerfjax_torch.parallel import make_mesh
from tests.synthetic import make_ray_npz

REPO = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 240
BASE = {
    "scene_name": "mp", "ngp": True, "nerf_type": "small", "hash_n_levels": 8, "hash_extra_dense_levels": 1,
    "batch_size": 64, "num_epochs": 1, "lr": 5e-3, "N_samples": 4, "N_importance": 4, "precision": "fp32",
    "occupancy_grid": True, "occ_resolution": 16, "occ_update_every": 2, "occ_segments": 8,
    "single_pass": False, "hash_grad_corners": 8, "hash_fwd_corners": 8,
}
RTOL = 1e-4  # the fp32 step bound (tests/test_torch_train_step.py)

WORKER = r"""
import json, os, runpy, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, REPO)
from nerfjax_torch.parallel import init_distributed
rank, world, port, tmp, job = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
spec = json.loads(open(os.path.join(tmp, job + ".json")).read())
if spec.get("from_env"):
    got = init_distributed(backend="gloo")
else:
    got = init_distributed(coordinator_address="localhost:" + port, num_processes=world, process_id=rank,
                           backend="gloo")
assert got == (rank, world), got
assert init_distributed() == got  # a second call joins nothing
import torch.distributed as dist
from nerfjax_torch import checkpoint as ckpt
from nerfjax_torch import train as T

def flat(p):
    return {"table": np.asarray(p["table"]),
            **{f"{n}{i}": np.asarray(l["w"]) for n in ("dmlp", "cmlp") for i, l in enumerate(p[n])}}

def out(name, arrays, info):
    np.savez(os.path.join(tmp, f"{name}_{rank}.npz"), **arrays)
    with open(os.path.join(tmp, f"{name}_{rank}.json"), "w") as f:
        json.dump(info, f)

if spec["kind"] == "env":
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    out(job, {}, {"sum": float(t), "backend": dist.get_backend()})
elif spec["kind"] == "train":
    for run in spec["runs"]:
        cfg = dict(spec["cfg"], **run["cfg"])
        for key in ("output_dir", "checkpoint_dir"):
            cfg[key] = cfg[key].format(rank=rank)
        res = T.train(cfg, seed=0, log_every=1, device="cpu", resume=run.get("resume", False))
        out(run["tag"], flat(res["params"]),
            {k: res[k] for k in ("psnr", "steps", "rank", "world", "table_optimizer_bytes", "metrics")})
elif spec["kind"] == "extract":
    from nerfjax_torch import extract as E
    E.FINE_CHUNK_CELLS = spec["chunk_cells"]
    for hier in (False, True):
        vol = E.extract_volume(spec["cfg"], resolution=spec["res"], device="cpu", hierarchical=hier,
                               dtype=torch.float32, verbose=False)
        md = {k: v for k, v in vol["metadata"].items() if k not in spec["timing_keys"]}
        out(f"extract_{int(hier)}", {"occ": vol["occupancy_volume"], "rgb": vol["rgb_volume"]}, md)
    cfg_path = os.path.join(tmp, f"cli_{rank}.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(spec["cfg"], volume_output_path=os.path.join(tmp, f"cli_volume_{rank}.pth")), f)
    sys.argv = ["extract_vol", "--cfg_path", cfg_path, "--device", "cpu", "-r", str(spec["res"])]
    runpy.run_module("nerfjax_torch.cli.extract_vol", run_name="__main__", alter_sys=False)
elif spec["kind"] == "step":
    from nerfjax_torch import render as R
    from nerfjax_torch.parallel import make_mesh
    d = dict(np.load(os.path.join(tmp, "step_inputs.npz")))
    B = d["rays_o"].shape[0] // world
    rows = slice(rank * B, (rank + 1) * B)
    z_imp = torch.from_numpy(d["z_imp"][rows])
    R.sample_pdf = lambda bins, w, n, *, u=None, generator=None: z_imp
    settings = T.TrainSettings.from_cfg(spec["cfg"], total_steps=100)
    state = T.make_train_state(spec["cfg"], settings, device="cpu")
    state.mesh = make_mesh()
    state.field.load_params({"table": torch.from_numpy(d["p_table"]),
                             "dmlp": [{"w": torch.from_numpy(d[f"p_dmlp{i}"])} for i in range(2)],
                             "cmlp": [{"w": torch.from_numpy(d[f"p_cmlp{i}"])} for i in range(3)]})
    batch = {k: torch.from_numpy(d[k][rows]) for k in ("rays_o", "rays_d", "rgb", "t_near", "t_far")}
    m = T.train_step(state, batch, u_strat=torch.from_numpy(d["u_strat"][rows]),
                     u_pdf=torch.from_numpy(d["u_pdf"][rows]))
    f = state.field
    grads = {"g_table": f.table.grad, **{f"g_{n}{i}": w.grad for n in ("dmlp", "cmlp")
                                         for i, w in enumerate(getattr(f, n))}}
    out("step", {**{k: v.numpy() for k, v in grads.items()}, **flat(ckpt.params_to_numpy(f.params()))},
        {k: float(v) for k, v in m.items()})
print("DONE", rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(tmp: Path, world: int, job: str, spec: dict, env_for=None) -> list[str]:
    """Start ``world`` ranks of WORKER on ``job`` (spec written to
    tmp/job.json, each rank's output to tmp/job_rank<r>.log); fail with
    every rank's output if one exits non-zero or they outlast
    CHILD_TIMEOUT_S, killing the rest. Returns the outputs."""
    (tmp / f"{job}.json").write_text(json.dumps(spec))
    port = _free_port()
    procs, logs = [], [tmp / f"{job}_rank{r}.log" for r in range(world)]
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for key in ("NERFJAX_COORDINATOR", "NERFJAX_NUM_PROCESSES", "NERFJAX_PROCESS_ID", "NERFJAX_DISTRIBUTED"):
            env.pop(key, None)
        env.update(env_for(r, port) if env_for else {})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", f"REPO = {str(REPO)!r}\n" + WORKER, str(r), str(world), str(port), str(tmp), job],
            env=env, stdout=logs[r].open("w"), stderr=subprocess.STDOUT))
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        p.wait()
    outs = [log.read_text() for log in logs]
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{job}: rank {r} exited {p.returncode}\n" + "\n".join(
            f"--- rank {i} ---\n{x[-5000:]}" for i, x in enumerate(outs))
    return outs


def _load(tmp: Path, name: str, rank: int) -> tuple[dict, dict]:
    return dict(np.load(tmp / f"{name}_{rank}.npz")), json.loads((tmp / f"{name}_{rank}.json").read_text())


def _flat(p: dict) -> dict:
    return {"table": np.asarray(p["table"]),
            **{f"{n}{i}": np.asarray(layer["w"]) for n in ("dmlp", "cmlp") for i, layer in enumerate(p[n])}}


def _close(got: dict, want: dict, what: str) -> None:
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=RTOL * np.abs(w).max(), err_msg=f"{what}: {name}")


def _equal(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys()
    for name in want:
        assert np.array_equal(got[name], want[name]), f"{what}: {name} differs"


def _cfg(tmp: Path, name: str, **over) -> dict:
    return {**BASE, "rays_file": str(tmp / "rays.npz"), "output_dir": str(tmp / name / "rank{rank}"),
            "checkpoint_dir": str(tmp / name / "rank{rank}" / "ckpt"), **over}


def _one_rank(tmp: Path, name: str, **over) -> dict:
    cfg = {k: v.format(rank=0) if isinstance(v, str) else v for k, v in _cfg(tmp, name, **over).items()}
    return T.train(cfg, seed=0, log_every=1, device="cpu")


@pytest.fixture
def rays(tmp_path):
    make_ray_npz(tmp_path / "rays.npz", n_rays=256, seed=5)
    return tmp_path


# -- in process: the blocks, the mesh, the start-up -------------------------------------------------


@pytest.mark.parametrize("count", [2, 4])
def test_batch_blocks_match_nerfjax(tmp_path, monkeypatch, count):
    import jax
    from nerfjax.data import RayDataset as JaxRayDataset
    from nerfjax.parallel import process_batch_slice as jax_slice

    from nerfjax_torch.data import RayDataset

    make_ray_npz(tmp_path / "r.npz", n_rays=1000, seed=1)
    mine, ref = RayDataset(tmp_path / "r.npz", verbose=False), JaxRayDataset(tmp_path / "r.npz", verbose=False)
    whole = list(mine.epoch_batches(128, seed=11))
    for p in range(count):
        got = list(mine.epoch_batches(128, seed=11, process_index=p, process_count=count))
        want = list(ref.epoch_batches(128, seed=11, process_index=p, process_count=count))
        assert len(got) == len(want) == 7
        monkeypatch.setattr(D, "rank", lambda: p)
        monkeypatch.setattr(D, "world_size", lambda: count)
        monkeypatch.setattr(jax, "process_index", lambda: p)
        monkeypatch.setattr(jax, "process_count", lambda: count)
        for a, b, full in zip(got, want, whole):
            assert a.keys() == b.keys() == full.keys()
            sliced, sliced_ref = D.process_batch_slice(full), jax_slice(full)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(sliced[k], sliced_ref[k])
                np.testing.assert_array_equal(sliced[k], a[k])
    for kwargs in ({"process_count": 3}, {"process_count": 2, "drop_last": False}):
        with pytest.raises(ValueError) as mine_err:
            next(mine.epoch_batches(128, seed=11, **kwargs))
        with pytest.raises(ValueError) as ref_err:
            next(ref.epoch_batches(128, seed=11, **kwargs))
        assert str(mine_err.value) == str(ref_err.value)


def test_init_distributed_is_a_noop_alone(monkeypatch):
    import torch.distributed as dist

    from nerfjax_torch.parallel import init_distributed

    for key in ("NERFJAX_COORDINATOR", "NERFJAX_NUM_PROCESSES", "NERFJAX_PROCESS_ID", "NERFJAX_DISTRIBUTED"):
        monkeypatch.delenv(key, raising=False)
    assert init_distributed() == (0, 1) and not dist.is_initialized()
    monkeypatch.setenv("NERFJAX_NUM_PROCESSES", "1")  # a world of one needs no rendezvous
    monkeypatch.setenv("NERFJAX_COORDINATOR", "localhost:1")
    assert init_distributed() == (0, 1) and not dist.is_initialized()
    batch = {"a": np.arange(6)}
    assert D.process_batch_slice(batch) is batch
    mesh = make_mesh()
    assert (mesh.shape, mesh.axis_names, mesh.rank, mesh.table_size) == ((1,), ("data",), 0, 1)


def test_mesh_shape_must_cover_the_world(devices):
    from nerfjax.parallel import make_mesh as jax_make_mesh

    assert make_mesh((1, 1)).axis_names == ("data", "model")
    for shape in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError) as mine:
            make_mesh(shape)
        with pytest.raises(ValueError) as ref:
            jax_make_mesh(devices[:1], shape=shape)
        assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("over", [{"ngp": False, "pos_L": 4, "dir_L": 2, "hidden_dim": 32},
                                  {"single_pass": True}, {}], ids=["vanilla", "single_pass", "two_pass"])
def test_rank_draws_are_rows_of_the_global_draws(over):
    """Each rank's draws (_global_draws) are its rows of those the one-rank
    render draws for the whole batch from the same generator state: the
    renders of the two blocks, joined, equal the render of the batch."""
    from nerfjax_torch.ops.occupancy import init_grid
    from nerfjax_torch.parallel import Mesh
    from nerfjax_torch.render import render_rays_planar

    cfg = {**BASE, **over}
    settings = T.TrainSettings.from_cfg(cfg, total_steps=10)
    state = T.make_train_state(cfg, settings, device="cpu")
    rng = np.random.default_rng(3)
    o = rng.normal(size=(64, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=1, keepdims=True)
    batch = {"rays_o": torch.from_numpy(o), "rays_d": torch.from_numpy(d),
             "t_near": torch.full((64,), 1.5), "t_far": torch.full((64,), 3.5)}
    grid = init_grid(settings.occ_spec())

    def render(rows, **draws):
        with torch.no_grad():
            return render_rays_planar(
                state.field_coarse or state.field, state.field, *(batch[k][rows] for k in ("rays_o", "rays_d",
                                                                                            "t_near", "t_far")),
                settings.n_samples, settings.n_importance, train=True, dtype=settings.dtype,
                occ_spec=settings.occ_spec(), occ_grid=grid, single_pass=settings.single_pass,
                generator=state.generator, **draws)

    state.generator.manual_seed(123)
    whole = render(slice(0, 64))
    parts = []
    for r in range(2):
        state.mesh = Mesh((2,), ("data",), r)
        state.generator.manual_seed(123)
        draws = T._global_draws(state, 32, {"u_strat": None, "u_pdf": None, "noise_coarse": None,
                                            "noise_fine": None})
        assert (draws["noise_fine"] is not None) == (not cfg["ngp"])
        parts.append(render(slice(32 * r, 32 * (r + 1)), **draws))
    for key in ("rgb_fine", "rgb_coarse", "z_vals"):
        joined = torch.cat([part[key] for part in parts], dim=0 if whole[key].shape[0] == 64 else 1)
        np.testing.assert_allclose(joined.numpy(), whole[key].numpy(), rtol=1e-5, atol=1e-6, err_msg=key)


# -- child processes over gloo ----------------------------------------------------------------------


@pytest.mark.parametrize("how", ["coordinator", "torchrun"])
def test_init_distributed_from_the_environment(tmp_path, how):
    """NERFJAX_COORDINATOR / NERFJAX_NUM_PROCESSES / NERFJAX_PROCESS_ID, or
    NERFJAX_DISTRIBUTED=1 with torchrun's variables: each rank joins as the
    rank the environment names, and a collective spans the world."""
    if how == "coordinator":
        def env_for(r, port):
            return {"NERFJAX_COORDINATOR": f"localhost:{port}", "NERFJAX_NUM_PROCESSES": "2",
                    "NERFJAX_PROCESS_ID": str(r)}
    else:
        def env_for(r, port):
            return {"NERFJAX_DISTRIBUTED": "1", "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r),
                    "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    _run_world(tmp_path, 2, "env", {"kind": "env", "from_env": True}, env_for)
    for r in range(2):
        _, info = _load(tmp_path, "env", r)
        assert info == {"sum": 3.0, "backend": "gloo"}


def test_two_ranks_train_like_one(tmp_path):
    """train() over two ranks for one epoch of one step equals one rank
    within the fp32 step bound (parameters, the step's loss and PSNR), both
    ranks hold the same parameters and the same occupancy grid (train()
    checks it), and rank 1 writes no file: its output_dir and
    checkpoint_dir are never made. One step: over more steps the two runs
    part by more than the step bound, since a sample point that moves by an
    ulp can cross a cell edge and send its table gradient to other entries
    (2 steps: 101 of 456,832 table entries beyond the bound, 4 steps: 1,241)."""
    make_ray_npz(tmp_path / "rays.npz", n_rays=64, seed=5)
    _run_world(tmp_path, 2, "dp", {"kind": "train", "cfg": _cfg(tmp_path, "dp"), "runs": [{"tag": "dp", "cfg": {}}]})
    one = _one_rank(tmp_path, "one")
    (p0, i0), (p1, i1) = _load(tmp_path, "dp", 0), _load(tmp_path, "dp", 1)
    _equal(p1, p0, "rank 1 against rank 0")
    _close(p0, _flat(one["params"]), "two ranks against one")
    np.testing.assert_allclose(i0["psnr"], one["psnr"], rtol=RTOL)
    for name in ("loss_total", "loss_coarse", "loss_fine"):
        np.testing.assert_allclose(i0["metrics"][name], one["metrics"][name], rtol=RTOL, err_msg=name)
    assert i0["steps"] == i1["steps"] == 1 and (i0["world"], i1["rank"]) == (2, 1)
    assert i0["metrics"] and not i1["metrics"]
    assert (tmp_path / "dp" / "rank0" / "ckpt" / "nerf_final.pth").exists()
    assert any((tmp_path / "dp" / "rank0" / "logs").iterdir())
    assert not (tmp_path / "dp" / "rank1").exists()


def test_two_ranks_shard_the_table(rays):
    """shard_hash_table over two ranks: the parameters equal the replicated
    run's bit for bit, and each rank holds half the table's AdamW moments."""
    _run_world(rays, 2, "tp", {"kind": "train", "cfg": _cfg(rays, "tp"), "runs": [
        {"tag": "repl", "cfg": {}}, {"tag": "shard", "cfg": {"shard_hash_table": True,
                                                           "output_dir": str(rays / "tp_s" / "rank{rank}"),
                                                           "checkpoint_dir": str(rays / "tp_s" / "rank{rank}" / "c")}}]})
    for r in range(2):
        (repl, ri), (shard, si) = _load(rays, "repl", r), _load(rays, "shard", r)
        _equal(shard, repl, f"rank {r}: sharded against replicated")
        assert si["table_optimizer_bytes"] * 2 == ri["table_optimizer_bytes"] > 0
    saved = ckpt.load_pth(rays / "tp_s" / "rank0" / "c" / "nerf_final.pth")
    moments = saved["optimizer_state_dict"]["state"]
    table = max(moments.values(), key=lambda s: s["exp_avg"].size)
    assert table["exp_avg"].shape == _load(rays, "shard", 0)[0]["table"].shape  # the whole table was written


def test_four_ranks_on_a_2x2_mesh(rays):
    """mesh_shape [2, 2]: the table split over each row's two ranks equals
    the replicated run on that mesh bit for bit, and the 2-D mesh equals the
    1-D mesh over the same four ranks within the fp32 step bound."""
    _run_world(rays, 4, "mesh", {"kind": "train", "cfg": _cfg(rays, "mesh"), "runs": [
        {"tag": "m2d_repl", "cfg": {"mesh_shape": [2, 2]}},
        {"tag": "m2d_shard", "cfg": {"mesh_shape": [2, 2], "shard_hash_table": True}},
        {"tag": "m1d", "cfg": {}}]})
    for r in range(4):
        (repl, ri), (shard, si) = _load(rays, "m2d_repl", r), _load(rays, "m2d_shard", r)
        _equal(shard, repl, f"rank {r}: sharded against replicated on the 2x2 mesh")
        assert si["table_optimizer_bytes"] * 2 == ri["table_optimizer_bytes"]
        _close(repl, _load(rays, "m1d", r)[0], f"rank {r}: 2x2 mesh against the 1-D mesh")


def test_two_ranks_resume_without_a_shared_checkpoint_dir(rays):
    """Three epochs straight through over two ranks, then the same run
    resumed from its epoch-2 checkpoint, which only rank 0's checkpoint_dir
    holds (rank 1's is empty): the resumed run equals the uninterrupted one
    within the fp32 step bound, and the two ranks are equal."""
    straight = _cfg(rays, "straight", num_epochs=3)
    _run_world(rays, 2, "straight", {"kind": "train", "cfg": straight, "runs": [{"tag": "straight", "cfg": {}}]})
    epoch2 = rays / "straight" / "rank0" / "ckpt" / "nerf_epoch_000002.pth"
    lead_dir, other_dir = rays / "resumed" / "rank0" / "ckpt", rays / "resumed" / "rank1" / "ckpt"
    lead_dir.mkdir(parents=True)
    other_dir.mkdir(parents=True)
    (lead_dir / epoch2.name).write_bytes(epoch2.read_bytes())
    outs = _run_world(rays, 2, "resumed", {"kind": "train", "cfg": _cfg(rays, "resumed", num_epochs=3),
                                          "runs": [{"tag": "resumed", "cfg": {}, "resume": True}]})
    assert "Resumed from" in outs[0] and "Resumed from" not in outs[1]
    (a0, ai), (a1, _) = _load(rays, "resumed", 0), _load(rays, "resumed", 1)
    _equal(a1, a0, "resumed: rank 1 against rank 0")
    _close(a0, _load(rays, "straight", 0)[0], "resumed against straight through")
    assert ai["steps"] == 12 and len(ai["psnr"]) == 4
    assert sorted(p.name for p in other_dir.iterdir()) == []


def test_two_rank_extraction_equals_one(tmp_path):
    """extract_volume at 64^3, exact and hierarchical (fine chunks of 64
    cells, so both ranks take chunks), over two ranks: the volumes, the
    threshold and the metadata equal the world of one's, bit for bit, on
    both ranks; the extract_vol CLI writes the volume on rank 0 only."""
    cfg = {**BASE, "checkpoint": str(tmp_path / "field.pth")}
    field = T.build_fields(cfg)[1]
    field.init(torch.Generator().manual_seed(4))
    ckpt.save_field_params(cfg["checkpoint"], cfg, ckpt.params_to_numpy(field.params()))
    timing = ["query_seconds", "transfer_seconds", "phase_seconds", "timestamp"]
    _run_world(tmp_path, 2, "extract", {"kind": "extract", "cfg": cfg, "res": 64, "chunk_cells": 64,
                                        "timing_keys": timing})
    orig, threads = E.FINE_CHUNK_CELLS, torch.get_num_threads()
    try:  # as the ranks run: the CPU's reductions (the density stats) sum in an order set by the thread count
        E.FINE_CHUNK_CELLS = 64
        torch.set_num_threads(1)
        for hier in (False, True):
            vol = E.extract_volume(cfg, resolution=64, device="cpu", hierarchical=hier, dtype=torch.float32,
                                   verbose=False)
            md = json.loads(json.dumps({k: v for k, v in vol["metadata"].items() if k not in timing}))
            if hier:
                assert md["marked_cells"] > 64 * 2  # more than one chunk a rank
            for r in range(2):
                arrays, got_md = _load(tmp_path, f"extract_{int(hier)}", r)
                assert np.array_equal(arrays["occ"], vol["occupancy_volume"]), (hier, r)
                assert np.array_equal(arrays["rgb"], vol["rgb_volume"]), (hier, r)
                assert got_md == md, (hier, r)
    finally:
        E.FINE_CHUNK_CELLS = orig
        torch.set_num_threads(threads)
    assert (tmp_path / "cli_volume_0.pth").exists() and not (tmp_path / "cli_volume_1.pth").exists()


def test_two_rank_step_matches_nerfjax_two_devices(tmp_path, devices):
    """One step of the port over two ranks against nerfjax's step over a
    two-device mesh (its sharded, compiled step), from the same parameters
    and batch, with nerfjax's uniforms and the importance depths pinned
    (tests/test_torch_train_step.py pins them so): the loss, the gradients
    reduced over the ranks and the parameters after AdamW, within the fp32
    step bound."""
    import jax
    import jax.numpy as jnp
    from nerfjax import render as jrender
    from nerfjax.config import ConfigNode
    from nerfjax.parallel import make_mesh as jax_make_mesh
    from nerfjax.train import TrainSettings as JaxSettings
    from nerfjax.train import build_fields as jax_build_fields
    from nerfjax.train import init_params, loss_fn, make_optimizer, make_train_step

    from nerfjax_torch import render as R

    cfg = {**BASE, "occupancy_grid": False}
    n = 64
    data = make_ray_npz(tmp_path / "r.npz", n_rays=n, seed=3)
    batch = {"rays_o": data["rays_o"], "rays_d": data["rays_d"], "rgb": data["rgbs"], "t_near": data["t_near"],
             "t_far": data["t_far"]}
    settings = T.TrainSettings.from_cfg(cfg, total_steps=100)
    settings_j = JaxSettings.from_cfg(ConfigNode(cfg), total_steps=100)
    fc, ff, _ = jax_build_fields(ConfigNode(cfg), train=True)
    k_init, k_train = jax.random.split(jax.random.PRNGKey(7))
    params_j = init_params(ConfigNode(cfg), k_init)
    skey = jax.random.fold_in(k_train, 0)
    k_strat, k_pdf = jax.random.split(skey, 4)[:2]
    u_strat = np.array(jax.random.uniform(k_strat, (n, settings.n_samples), jnp.float32))
    u_pdf = np.array(jax.random.uniform(k_pdf, (n, settings.n_importance), jnp.float32))
    # the importance depths, from the port's sampler at the initial field (one rank, the whole batch)
    state = T.make_train_state(cfg, settings, device="cpu")
    state.field.load_params(ckpt.params_from_jax(params_j["model"]))
    seen, real = [], R.sample_pdf
    R.sample_pdf = lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1]
    try:
        with torch.no_grad():
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            R.render_rays_planar(state.field, state.field, tb["rays_o"], tb["rays_d"], tb["t_near"], tb["t_far"],
                                 settings.n_samples, settings.n_importance, train=True, dtype=settings.dtype,
                                 u_strat=torch.from_numpy(u_strat), u_pdf=torch.from_numpy(u_pdf))
    finally:
        R.sample_pdf = real
    z_imp = seen[0].numpy()
    np.savez(tmp_path / "step_inputs.npz", **batch, u_strat=u_strat, u_pdf=u_pdf, z_imp=z_imp,
             **{f"p_{k}": v for k, v in _flat(params_j["model"]).items()})
    _run_world(tmp_path, 2, "step", {"kind": "step", "cfg": cfg})

    orig = jrender.sample_pdf
    jrender.sample_pdf = lambda key, bins, w, n_, u=None: jnp.asarray(z_imp)
    try:
        tx = make_optimizer(settings_j)
        mesh = jax_make_mesh(devices[:2])
        step = make_train_step(settings_j, fc, ff, tx, mesh)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (_, _), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=(3, 4, 5))(
            params_j, jbatch, skey, fc, ff, settings_j, jnp.zeros((1,), jnp.float32))
        gref = _flat(jax.device_get(grads_j["model"]))
        new_j, _, _, _, metrics_j = step(params_j, tx.init(params_j), jnp.zeros((), jnp.int32),  # donates params_j
                                         jnp.zeros((1,), jnp.float32), k_train, jbatch)
    finally:
        jrender.sample_pdf = orig
    after_j = _flat(jax.device_get(new_j)["model"])
    for r in range(2):
        arrays, metrics = _load(tmp_path, "step", r)
        for name in ("loss_total", "loss_coarse", "loss_fine", "psnr"):
            np.testing.assert_allclose(metrics[name], float(metrics_j[name]), rtol=RTOL, err_msg=name)
        _close({k: arrays[f"g_{k}"] for k in gref}, gref, f"rank {r}: gradients")
        for name, pj in after_j.items():  # AdamW's first update: lr x sign(g) where |g| is not near eps
            sure = np.abs(gref[name]) > 1e-6
            assert sure.any(), name
            err = np.abs(arrays[name] - pj)[sure]
            assert err.max(initial=0.0) <= 1e-3 * cfg["lr"], (r, name, err.max())
    _equal(_load(tmp_path, "step", 1)[0], _load(tmp_path, "step", 0)[0], "rank 1 against rank 0")
