"""nerfjax_torch.tracing on the CPU at tiny sizes: no span without a
profiler session; under one, the spans of a train step, a frame and a
volume, with their parents, unit ids, counts and times; outputs bit-equal
with recording on and off; the cap; and every per-layer metric of the
benchmark that reads the spans returns a number from a CPU run."""

import io
import json
import math
import threading
import time

import numpy as np
import pytest
import torch

from nerfjax_torch import tracing
from nerfjax_torch.data import RayDataset, prefetch_to_device
from nerfjax_torch.extract import extract_volume
from nerfjax_torch.rays import get_rays, ray_cube_intersection
from nerfjax_torch.render_image import render_image
from nerfjax_torch.train import TrainSettings, build_fields, make_train_state, train, train_step
from portbench import traffic
from tests.synthetic import make_ray_npz

CPU = [torch.profiler.ProfilerActivity.CPU]
NGP = {"ngp": True, "nerf_type": "small", "hash_n_levels": 8, "batch_size": 64, "N_samples": 8,
       "N_importance": 16, "precision": "bf16", "occupancy_grid": False, "single_pass": False, "num_epochs": 1,
       "lr": 5e-4}
SINGLE = {**NGP, "hash_extra_dense_levels": 1, "occupancy_grid": True, "single_pass": True, "occ_resolution": 16,
          "occ_update_every": 1, "occ_update_partitions": 4, "occ_fast_cdf": True, "occ_segments": 8}
FRAME = {"H": 24, "W": 24, "chunk_rays": 128}
UNITS = {"train.step", "render.frame", "extract.volume"}
HELPER_WAITS = {"wait.upload", "wait.otsu_hist", "wait.otsu_argmax"}  # waits inside helpers, under any stage


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and beside the suite's other workers many threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rays(tmp_path_factory):
    path = tmp_path_factory.mktemp("rays") / "rays.npz"
    make_ray_npz(path, n_rays=256, seed=2)
    return RayDataset(path, verbose=False)


@pytest.fixture(scope="module")
def sphere():
    field = build_fields(NGP, device="cpu")[1]
    field.load_params(traffic.sphere_field(NGP, 5, {"radius": 0.5, "center_range": 0.1, "gain": 40.0}, "cpu"))
    return field


def _pose():
    return traffic.intrinsics(FRAME["H"], FRAME["W"], 0.69), traffic.orbit_poses(5, 4, 4.03, 30.0)[1]


def _unit_of(kind, rays, sphere):
    """A callable that runs two units of ``kind`` from the same start and
    returns their outputs as numpy arrays."""
    if kind in ("train", "train_single"):
        cfg = NGP if kind == "train" else SINGLE

        def run():
            state = make_train_state(cfg, TrainSettings.from_cfg(cfg, 10), seed=1, device="cpu")
            feed = prefetch_to_device(rays.epoch_batches(64, seed=3), "cpu")
            losses = [train_step(state, next(feed))["loss_total"] for _ in range(2)]
            p = state.params()
            return [np.asarray([float(v) for v in losses]), p["table"], *(l["w"] for l in p["dmlp"] + p["cmlp"])]
        return run
    if kind == "render":
        K, c2w = _pose()
        return lambda: [render_image(sphere, K, c2w, FRAME["H"], FRAME["W"], n_samples=8, n_importance=16,
                                     chunk_rays=FRAME["chunk_rays"]) for _ in range(2)]

    def run():
        vols = [extract_volume(NGP, params={"model": sphere.params()}, resolution=32, device="cpu", verbose=False,
                               hierarchical=True) for _ in range(2)]
        return [a for v in vols for a in (v["occupancy_volume"], v["rgb_volume"],
                                          np.asarray(v["metadata"]["threshold"]))]
    return run


def _recorded(run):
    tracing.clear()
    with torch.profiler.profile(activities=CPU):
        before = time.time_ns()
        out = run()
        after = time.time_ns()
    return out, list(tracing.RECORDER.records), before, after


KINDS = ["train", "train_single", "render", "extract"]


@pytest.mark.parametrize("kind", KINDS)
def test_no_span_without_a_profiler(kind, rays, sphere):
    with torch.profiler.profile(activities=CPU):  # a session before: its span is kept until the unit below
        with tracing.unit("left.over", 0):
            pass
    assert len(tracing.RECORDER.records) == 1
    _unit_of(kind, rays, sphere)()
    assert tracing.RECORDER.records == [] and tracing.counters()["tracing.dropped"] == 0
    assert tracing.span("x") is tracing.NO_SPAN and tracing.unit("x", 0) is tracing.NO_SPAN


EXPECTED = {  # name -> the name of its parent (None: no parent)
    "train": {"feed.gather": None, "train.step": None, "train.forward": "train.step",
              "render.sample": "train.forward", "render.field": "train.forward", "render.composite": "train.forward",
              "render.pdf": "train.forward", "train.backward": "train.step", "train.optimizer": "train.step",
              "wait.cumprod_backward": "train.backward"},  # autograd runs a CPU backward on the calling thread
    "render": {"render.frame": None, "render.rays": "render.frame", "wait.hit_rays": "render.frame",
               "render.chunk": "render.frame", "render.sample": "render.chunk", "render.field": "render.chunk",
               "render.composite": "render.chunk", "render.pdf": "render.chunk", "wait.frame_to_host": "render.frame"},
    "extract": {"extract.volume": None, "extract.build": "extract.volume", "extract.coarse": "extract.volume",
                "extract.mark": "extract.volume", "wait.mark_to_host": "extract.mark", "extract.fine": "extract.volume",
                "extract.otsu": "extract.volume", "wait.stats": "extract.otsu", "extract.fetch": "extract.volume",
                "wait.fetch_copy": "extract.fetch", "extract.fetch.unpack": "extract.fetch",
                "extract.fetch.scatter": "extract.fetch", "extract.count": "extract.volume"},
}
EXPECTED["train_single"] = {**{k: v for k, v in EXPECTED["train"].items() if k != "render.pdf"},
                            "train.occupancy": "train.step"}


@pytest.mark.parametrize("kind", KINDS)
def test_spans_parents_units_and_times(kind, rays, sphere):
    _, recs, before, after = _recorded(_unit_of(kind, rays, sphere))
    expected = EXPECTED[kind]
    names = {r.name for r in recs}
    assert set(expected) <= names <= set(expected) | HELPER_WAITS
    units = [r for r in recs if r.name in UNITS]
    assert len(units) == 2 and all(r.unit == r.id for r in units)
    for i, r in enumerate(recs):
        assert r.index == i and before <= r.start_ns <= r.end_ns <= after
        parent = None if r.parent is None else recs[r.parent]
        want = expected.get(r.name)
        if r.name in HELPER_WAITS and r.name not in expected:
            want = parent.name if parent is not None and parent.name in expected else "?"
        assert (parent.name if parent else None) == want, r.name
        if parent is not None:
            assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
            assert not (r.name.startswith("wait.") and parent.name.startswith("wait.")), r.name
        unit = next((u for u in units if u.start_ns <= r.start_ns and r.end_ns <= u.end_ns), None)
        assert r.unit == (None if unit is None else unit.id), r.name
    if kind.startswith("train"):
        assert [u.id for u in units] == [0, 1] and all(u.counts == {"rays": 64} for u in units)
        assert [r.counts for r in recs if r.name == "feed.gather"] == [{"rows": 64}] * 2
        passes = ["fine"] if kind == "train_single" else ["coarse", "fine"]
        assert [r.id for r in recs if r.name == "render.field"] == passes * 2
    uploads = {recs[r.parent].name for r in recs if r.name == "wait.upload"}
    if kind != "extract":  # linspace01's last entry; a frame's pose and get_rays' constants
        assert uploads == {"render.sample"} | ({"render.rays"} if kind == "render" else set())
    if kind == "extract":  # the mark's and the volume's Otsu, twice
        argmax = [recs[r.parent].name for r in recs if r.name == "wait.otsu_argmax"]
        assert argmax == ["extract.mark", "extract.otsu"] * 2
        assert sum(r.name == "wait.otsu_hist" for r in recs) == 4
        assert uploads == {"extract.coarse", "extract.mark", "extract.fine", "extract.fetch"}


def test_frame_counts_are_the_hit_and_padded_rays(sphere):
    K, c2w = _pose()
    _, recs, _, _ = _recorded(lambda: render_image(sphere, K, c2w, FRAME["H"], FRAME["W"], n_samples=8,
                                                   n_importance=16, chunk_rays=FRAME["chunk_rays"]))
    rays_o, rays_d = get_rays(FRAME["H"], FRAME["W"], K, torch.as_tensor(c2w)[None])
    n_hit = int(ray_cube_intersection(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3))[0].sum())
    chunk = FRAME["chunk_rays"]
    n_pad = -(-n_hit // chunk) * chunk
    (frame,) = [r for r in recs if r.name == "render.frame"]
    assert 0 < n_hit < n_pad and frame.counts == {"hit_rays": n_hit, "rays": n_pad, "chunks": n_pad // chunk}
    assert [r.id for r in recs if r.name == "render.chunk"] == list(range(0, n_pad, chunk))


def test_the_cap_counts_the_spans_dropped(sphere, monkeypatch):
    K, c2w = _pose()

    def frame():
        return render_image(sphere, K, c2w, FRAME["H"], FRAME["W"], n_samples=8, n_importance=16,
                            chunk_rays=FRAME["chunk_rays"])
    total = len(_recorded(frame)[1])
    monkeypatch.setattr(tracing.RECORDER, "cap", 5)
    _, recs, _, _ = _recorded(frame)
    assert len(recs) == 5 and tracing.RECORDER.dropped == total - 5 > 0
    assert tracing.counters()["tracing.dropped"] == total - 5
    assert all(r.end_ns is not None for r in recs)  # the spans kept still close


@pytest.mark.parametrize("kind", KINDS)
def test_outputs_equal_with_recording_on_and_off(kind, rays, sphere):
    run = _unit_of(kind, rays, sphere)
    off = run()
    on, recs, _, _ = _recorded(run)
    assert recs and len(on) == len(off)
    for a, b in zip(on, off):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_a_session_keeps_its_spans_until_a_unit_runs_outside_one(sphere):
    K, c2w = _pose()
    _, recs, _, _ = _recorded(lambda: torch.zeros(1))
    with torch.profiler.profile(activities=CPU):
        with tracing.unit("render.frame", 7) as u:
            u.count("hit_rays", 3)
    kept = list(tracing.RECORDER.records)
    assert [(r.name, r.id, r.counts) for r in kept] == [("render.frame", 7, {"hit_rays": 3})]
    with tracing.span("train.forward"):  # recording off: nothing changes
        pass
    assert tracing.RECORDER.records == kept
    render_image(sphere, K, c2w, FRAME["H"], FRAME["W"], n_samples=8, n_importance=16, chunk_rays=128)
    assert tracing.RECORDER.records == []


def test_each_thread_has_its_own_parents():
    seen = {}

    def other():
        with tracing.span("feed.gather") as sp:
            seen["parent"] = sp.parent

    tracing.clear()
    with torch.profiler.profile(activities=CPU):
        with tracing.unit("train.step", 3):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen == {"parent": None}
    (gather,) = [r for r in tracing.RECORDER.records if r.name == "feed.gather"]
    assert gather.unit is None


def test_idle_gaps_take_the_innermost_program_span():
    from portbench.trace import DeviceTrace

    tracing.clear()
    with torch.profiler.profile(activities=CPU):
        with tracing.unit("train.step", 0):
            with tracing.span("train.forward"):
                time.sleep(0.004)
                with tracing.span("wait.feed_slot"):
                    time.sleep(0.004)
    step, fwd, wait = tracing.RECORDER.records
    assert tracing.RECORDER.items == [(r.name, r.start_ns, r.end_ns) for r in (step, fwd, wait)]
    # the card idle from 1 ms into the forward to 1 ms before the wait, and from 1 ms into the wait to its end
    ms = 1_000_000
    events = [("k", step.start_ns, fwd.start_ns + ms), ("k", wait.start_ns - ms, wait.start_ns + ms),
              ("k", wait.end_ns, step.end_ns)]
    gaps = DeviceTrace(events, step.start_ns, step.end_ns).idle_gaps(tracing.RECORDER)
    assert sorted(name for name, _ in gaps) == ["host:train.forward", "host:wait.feed_slot"]


def test_launch_counts_are_in_the_counters_snapshot():
    from nerfjax_torch.ops import fused_mlp, hash_encode

    hash_encode.launch_counts["hash_levels_fwd"] += 3
    snap = tracing.counters()
    assert snap["hash_encode.hash_levels_fwd"] == hash_encode.launch_counts["hash_levels_fwd"]
    assert {f"fused_mlp.{k}" for k in fused_mlp.launch_counts} <= set(snap)
    hash_encode.reset_launch_counts()
    assert tracing.counters()["hash_encode.hash_levels_fwd"] == 0


def test_train_profile_dir_writes_the_spans(tmp_path):
    make_ray_npz(tmp_path / "rays.npz", n_rays=256, seed=2)
    cfg = {**SINGLE, "batch_size": 128, "rays_file": str(tmp_path / "rays.npz"), "output_dir": str(tmp_path / "out"),
           "checkpoint_dir": str(tmp_path / "ckpt")}
    out = train(cfg, device="cpu", log_every=1000, profile_dir=str(tmp_path / "prof"))
    assert (tmp_path / "prof" / "trace.json").exists()
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert spans["clock"] == "time.time_ns" and spans["dropped"] == 0
    assert "hash_encode.hash_levels_fwd" in spans["counters"]
    steps = [s for s in spans["spans"] if s["name"] == "train.step"]
    assert [s["id"] for s in steps] == list(range(out["steps"])) == [0, 1]
    for s in spans["spans"]:
        assert s["start_ns"] <= s["end_ns"] and set(s) == {"name", "id", "start_ns", "end_ns", "parent", "unit",
                                                           "counts"}
        if s["name"] in ("train.forward", "train.backward", "train.optimizer", "train.occupancy"):
            parent = spans["spans"][s["parent"]]
            assert parent["name"] == "train.step" and s["unit"] == parent["id"]


READERS = {  # metric -> the cell whose CPU run it reads
    "feed_gather_ms.train": "ngp_dropin.train", "forward_ms.train": "ngp_dropin.train",
    "backward_ms.train": "nerf_vanilla.train", "optimizer_ms.train": "ngp_dropin.train",
    "host_wait_ms.train": "nerf_vanilla.train", "chunk_ms.render": "ngp_dropin.render",
    "ray_yield.render": "ngp_dropin.render", "host_wait_ms.render": "ngp_dropin.render",
    "mark_s.extract": "ngp_dropin.extract", "fetch_host_s.extract": "ngp_dropin.extract",
    "host_wait_s.extract": "ngp_dropin.extract",
}


@pytest.fixture(scope="module")
def cpu_lines():
    """Each cell run once on the CPU at the benchmark tests' tiny sizes,
    traced, inside a CPU profiler session."""
    from portbench.harness import ROOT, load_module, run_cell

    helpers = load_module(ROOT / "portbench" / "tests" / "pb_helpers.py", "pb_helpers")
    lines = {}

    def get(cell):
        if cell not in lines:
            with torch.profiler.profile(activities=CPU):
                lines[cell] = run_cell(cell, helpers.SEED, 0.05, True, device="cpu", overrides=helpers.tiny(cell),
                                       stream=io.StringIO())
        return lines[cell]
    return get


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_reader_reads_a_cpu_run(metric, cpu_lines):
    line = cpu_lines(READERS[metric])
    value = line["metrics"][metric]["value"]
    assert isinstance(value, float) and math.isfinite(value) and value >= 0
    if metric == "ray_yield.render":
        assert 0 < value <= 100
    elif not metric.startswith("host_wait"):
        assert value > 0
