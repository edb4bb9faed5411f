"""The front end of nerfjax_torch (image preparation, the COLMAP text model,
the normalizers, the conversion to a transforms JSON, the re-centering, the
COLMAP driver and their CLIs) against nerfjax's, on the same inputs: the
scenes of tests/test_colmap.py and tests/test_colmap_adversarial.py.

Arrays are held with np.array_equal, written files byte for byte, the
normalizers' (scale, center) with ==. The statistical filter's kNN runs
through the port's plain version on the CPU and through nerfjax's native
C++ kernel, which can differ by a few float32 ulps (tests/test_torch_knn.py);
on these scenes the keep sets, and so everything after them, are equal.
"""

import contextlib
import io
import runpy
import stat
import sys
from pathlib import Path

import numpy as np
import pytest

from nerfjax import native
from nerfjax.colmap import convert as jconvert
from nerfjax.colmap import driver as jdriver
from nerfjax.colmap import model_io as jio
from nerfjax.colmap import normalize as jnorm
from nerfjax.colmap import quaternion as jq
from nerfjax.colmap import transform as jtransform
from nerfjax.config import ConfigNode as JaxConfigNode
from nerfjax.gui import viewers as jviewers
from nerfjax.utils import images as jimages
from nerfjax_torch import colmap as port_colmap
from nerfjax_torch.colmap import convert, driver, model_io, normalize, quaternion, transform
from nerfjax_torch.config import ConfigNode, with_defaults
from nerfjax_torch.gui import viewers
from nerfjax_torch.utils import images
from tests.test_colmap import _make_colmap_scene
from tests.test_colmap_adversarial import _make_adversarial_scene
from tests.test_torch_native_ref import nerfjax_native

SCENES = {"ring": _make_colmap_scene, "adversarial": lambda tmp: _make_adversarial_scene(tmp)[:2]}
METHODS = [None, "adaptive", "percentile", "statistical", "hybrid"]
CAMERA_LINES = [
    "1 SIMPLE_PINHOLE 640 480 500.0 320.0 240.0",
    "1 PINHOLE 640 480 500.0 510.5 321.0 239.5",
    "1 SIMPLE_RADIAL 640 480 500.0 320.0 240.0 0.01",
    "1 RADIAL 640 480 500.0 320.0 240.0 0.01 -0.002",
    "1 OPENCV 640 480 500.0 505.0 321.0 239.0 0.01 -0.002 0.0003 0.0004",
    "1 SIMPLE_RADIAL_FISHEYE 640 480 500.0 320.0 240.0 0.01",
    "1 RADIAL_FISHEYE 640 480 500.0 320.0 240.0 0.01 -0.002",
    "1 OPENCV_FISHEYE 640 480 500.0 505.0 321.0 239.0 0.01 -0.002 0.0003 0.0004",
    "1 FOV 640 480 500.0 320.0 240.0 0.9",
]


def _port_cfg(jcfg) -> ConfigNode:
    return with_defaults(ConfigNode(jcfg.to_dict()))


@pytest.fixture(scope="module", autouse=True)
def _nerfjax_native_loaded():
    """nerfjax's statistical filter below takes its native kNN."""
    nerfjax_native()


def _scene(name: str, tmp_path: Path):
    """(nerfjax cfg, port cfg, points) of one scene."""
    jcfg, pts = SCENES[name](tmp_path)
    return jcfg, _port_cfg(jcfg), pts


def _dicts_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_dicts_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_dicts_equal(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def test_nerfjax_kNN_is_native():
    """Every comparison of the statistical filter below is with nerfjax's
    native C++ path (the one it runs wherever g++ exists)."""
    assert nerfjax_native() is not None and native.load() is not None


# -- quaternion -----------------------------------------------------------------


def test_quaternion_helpers_equal():
    rng = np.random.default_rng(0)
    quats = [q / np.linalg.norm(q) for q in rng.normal(size=(40, 4))]
    # one rotation per branch of Shepperd's method (trace > 0; R00, R11, R22 largest)
    mats = [jq.quat_to_matrix(q) for q in quats] + [np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                                                      np.diag([-1.0, -1, 1]), np.eye(3)]
    for q in quats + [np.array([2.0, 0, 0, 0])]:
        assert np.array_equal(quaternion.quat_to_matrix(q), jq.quat_to_matrix(q))
    for R in mats:
        assert np.array_equal(quaternion.matrix_to_quat(R), jq.matrix_to_quat(R))
    for theta in rng.uniform(-7, 7, 10):
        for axis in "xyz":
            name = f"rotation_{axis}"
            assert np.array_equal(getattr(quaternion, name)(theta), getattr(jq, name)(theta))
    pairs = [tuple(rng.normal(size=(2, 3))) for _ in range(20)]
    pairs += [([0, 0, 1], [0, 0, -1]), ([1, 0, 0], [-1, 0, 0]), ([0, 2, 0], [0, 1, 0]), ([1, 1e-12, 0], [1, 0, 0])]
    for a, b in pairs:
        assert np.array_equal(quaternion.rotation_between_vectors(a, b), jq.rotation_between_vectors(a, b))


# -- model I/O --------------------------------------------------------------------


@pytest.mark.parametrize("line", CAMERA_LINES, ids=lambda s: s.split()[1])
def test_read_cameras_equal(tmp_path, line):
    path = tmp_path / "cameras.txt"
    path.write_text("# cameras\n\n" + line + "\n2 PINHOLE 1 1 1 1 1 1\n")
    assert _dicts_equal(model_io.read_cameras_txt(path), jio.read_cameras_txt(path))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_read_model_equal(tmp_path, scene):
    _scene(scene, tmp_path)
    work = next(tmp_path.glob("data/*/colmap_text"))
    for full in (False, True):
        got, want = model_io.read_points3d_txt(work / "points3D.txt", full), jio.read_points3d_txt(
            work / "points3D.txt", full)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert _dicts_equal(a, b)
    assert _dicts_equal(model_io.read_images_txt(work / "images.txt"), jio.read_images_txt(work / "images.txt"))


def test_read_images_with_empty_and_full_points2d_lines(tmp_path):
    """The robust empty-points2D handling (model_io.py:105-141): blank and
    populated observation lines, comments between records, a missing name."""
    path = tmp_path / "images.txt"
    path.write_text("# header\n1 1 0 0 0 0 0 0 1 a.png\n\n2 0.5 0.5 0.5 0.5 1 2 3 1 b.png\n"
                    "10.0 20.0 -1 30.5 40.5 7\n# comment\n3 1 0 0 0 4 5 6 2\n\n")
    got, want = model_io.read_images_txt(path), jio.read_images_txt(path)
    assert len(got) == 3 and _dicts_equal(got, want)
    assert got[1]["points2d_line"] == "10.0 20.0 -1 30.5 40.5 7"


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_written_model_byte_equal(tmp_path, scene):
    _scene(scene, tmp_path)
    work = next(tmp_path.glob("data/*/colmap_text"))
    _, _, records = jio.read_points3d_txt(work / "points3D.txt", full=True)
    poses = jio.read_images_txt(work / "images.txt")
    poses[0]["points2d_line"] = "1.5 2.5 -1"
    model_io.write_points3d_txt(records, tmp_path / "p_port.txt")
    jio.write_points3d_txt(records, tmp_path / "p_jax.txt")
    model_io.write_images_txt(poses, tmp_path / "i_port.txt")
    jio.write_images_txt(poses, tmp_path / "i_jax.txt")
    assert (tmp_path / "p_port.txt").read_bytes() == (tmp_path / "p_jax.txt").read_bytes()
    assert (tmp_path / "i_port.txt").read_bytes() == (tmp_path / "i_jax.txt").read_bytes()


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_recentered_model_byte_equal(tmp_path, scene, rotate):
    for side in ("port", "jax"):
        _scene(scene, tmp_path / side)
    work = {side: next((tmp_path / side).glob("data/*/colmap_text")) for side in ("port", "jax")}
    got = transform.recenter_colmap_model(work["port"], rotate_to_mean_view=rotate, verbose=False)
    want = jtransform.recenter_colmap_model(work["jax"], rotate_to_mean_view=rotate, verbose=False)
    assert _dicts_equal(got, want)
    for name in ("points3D.txt", "images.txt", "cameras.txt"):
        assert (work["port"] / name).read_bytes() == (work["jax"] / name).read_bytes(), name


# -- normalization and conversion ---------------------------------------------------


@pytest.mark.parametrize("radius_filter", [False, True])
@pytest.mark.parametrize("method", METHODS, ids=str)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_normalization_equal(tmp_path, scene, method, radius_filter):
    """resolve_normalization: equal (scale, center) and info for every
    normalization_method, with and without the radius pre-filter."""
    jcfg, _, pts = _scene(scene, tmp_path)
    keys = {"normalization_method": method}
    if radius_filter:
        keys.update(radius_filter=True, radius_radius=2.5 if scene == "adversarial" else 0.5, radius_nb_points=10)
    jcfg = jcfg.merge(keys)
    with contextlib.redirect_stdout(io.StringIO()) as out_port:
        got = convert.resolve_normalization(pts, _port_cfg(jcfg), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as out_jax:
        want = jconvert.resolve_normalization(pts, jcfg)
    assert got[0] == want[0] and np.array_equal(got[1], want[1]) and _dicts_equal(got[2], want[2])
    assert out_port.getvalue() == out_jax.getvalue()


@pytest.mark.parametrize("method", ["adaptive", "percentile", "statistical", "hybrid"])
def test_robust_bbox_chain_equal(method):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 7, size=(2000, 3))
    pts[:7] = rng.normal(size=(7, 3)) * 300.0  # fails the self-check: the fallback chain runs
    with contextlib.redirect_stdout(io.StringIO()):
        for fn, jfn in ((normalize.robust_bbox_computation, jnorm.robust_bbox_computation),
                        (normalize.robust_bbox_with_fallback, jnorm.robust_bbox_with_fallback),
                        (normalize.normalize_with_reference_fallback, jnorm.normalize_with_reference_fallback)):
            got, want = fn(pts, method, device="cpu"), jfn(pts, method)
            assert np.array_equal(got[0], want[0]) and got[1] == want[1] and _dicts_equal(got[2], want[2])
    frames = [{"transform_matrix": np.eye(4).tolist()}, {"transform_matrix": np.diag([1.0, -1, -1, 1]).tolist()}]
    assert normalize.compute_near_far_bounds(pts, frames) == jnorm.compute_near_far_bounds(pts, frames)
    assert normalize.adaptive_percentile_bounds(pts[:50]) == jnorm.adaptive_percentile_bounds(pts[:50])


def test_reference_fallback_equal_and_card_errors_raise(monkeypatch):
    """The whole computation raises (a 50/50 percentile box has no extent):
    both degrade loudly to the 1/99 percentile bbox the same way. An error
    of the card (RuntimeError: a failed build or launch) or the kNN's k
    limit is raised instead: a card run never falls back (the errors that
    are not RuntimeErrors: test_card_knn_errors_never_fall_back)."""
    from nerfjax_torch.ops.knn import KernelLimitError

    pts = np.random.default_rng(8).normal(size=(400, 3))
    with contextlib.redirect_stdout(io.StringIO()) as out_port:
        got = normalize.normalize_with_reference_fallback(pts, "percentile", device="cpu", lower=50.0, upper=50.0)
    with contextlib.redirect_stdout(io.StringIO()) as out_jax:
        want = jnorm.normalize_with_reference_fallback(pts, "percentile", lower=50.0, upper=50.0)
    assert got[2]["method"] == "fallback" and out_port.getvalue() == out_jax.getvalue()
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] and _dicts_equal(got[2], want[2])
    for err in (RuntimeError("knn_mean_distances: kernel launch failed with cudaError 700"),
                KernelLimitError("k = 300 exceeds the kernel's limit K_MAX = 256")):
        def fail(*args, err=err, **kwargs):
            raise err

        monkeypatch.setattr(normalize, "remove_statistical_outliers", fail)
        with pytest.raises(type(err)), contextlib.redirect_stdout(io.StringIO()):
            normalize.normalize_with_reference_fallback(pts, "statistical", device="cpu")


@pytest.mark.parametrize("error", [OSError("libknn.so: cannot open shared object file"),
                                   PermissionError(13, "Permission denied: nvcc"),
                                   AttributeError("undefined symbol: nerf_knn_mean_dist"),
                                   AssertionError("Torch not compiled with CUDA enabled")])
@pytest.mark.parametrize("method", ["statistical", "hybrid"])
def test_card_knn_errors_never_fall_back(monkeypatch, method, error):
    """Whatever the kNN raises off the CPU (a library that does not load,
    nvcc that does not run, a missing symbol, a missing card) reaches the
    caller of normalize_with_reference_fallback as a RuntimeError, never its
    degrade-to-percentiles path. On the CPU the same error degrades as
    nerfjax's does. The "meta" device stands for a card here."""
    from nerfjax_torch.colmap import outliers

    def fail(*args, **kwargs):
        raise error

    pts = np.random.default_rng(8).normal(size=(400, 3))
    monkeypatch.setattr(outliers, "knn_mean_distances", fail)
    with pytest.raises(RuntimeError, match=type(error).__name__) as info, \
            contextlib.redirect_stdout(io.StringIO()) as out:
        normalize.normalize_with_reference_fallback(pts, method, device="meta")
    assert info.value.__cause__ is error and "Falling back" not in out.getvalue()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = normalize.normalize_with_reference_fallback(pts, method, device="cpu")
    assert got[2] == {"method": "fallback", "error": str(error)} and "Falling back" in out.getvalue()


def test_card_knn_build_errors_never_fall_back(monkeypatch):
    """_build.load raising OSError (the reviewer's case: ctypes cannot load
    the library) is a RuntimeError of ops.knn; on a machine without a card
    the transfer to cuda fails first, and that too is a RuntimeError."""
    from nerfjax_torch import _build
    from nerfjax_torch.ops import knn

    def fail(name):
        raise OSError(f"lib{name}.so: cannot open shared object file")

    pts = np.random.default_rng(8).normal(size=(400, 3))
    knn._lib.cache_clear()
    monkeypatch.setattr(_build, "load", fail)
    try:
        with pytest.raises(RuntimeError, match="OSError"):
            knn._lib()
        monkeypatch.setattr(_build, "load", lambda name: object())  # a library without the kernel's symbols
        with pytest.raises(RuntimeError, match="AttributeError"):
            knn._lib()
        with pytest.raises(RuntimeError), contextlib.redirect_stdout(io.StringIO()) as out:
            normalize.normalize_with_reference_fallback(pts, "statistical", device="cuda")
        assert "Falling back" not in out.getvalue()
    finally:
        knn._lib.cache_clear()


@pytest.mark.parametrize("mode", ["auto", "auto+z", "euler"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_colmap_to_nerf_json_byte_equal(tmp_path, scene, mode):
    jcfg, cfg, _ = _scene(scene, tmp_path)
    if mode == "euler":
        jcfg = jcfg.merge({"angles": [10, -20, 35], "rot_order": [2, 0, 1]})
        cfg = _port_cfg(jcfg)
    with contextlib.redirect_stdout(io.StringIO()) as out_port:
        got = convert.colmap_to_nerf(cfg, mode=mode, device="cpu")
        convert.write_transforms_json(got["transform"], tmp_path / "port.json")
    with contextlib.redirect_stdout(io.StringIO()) as out_jax:
        want = jconvert.colmap_to_nerf(jcfg, mode=mode)
        jconvert.write_transforms_json(want["transform"], tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert np.array_equal(got["points"], want["points"]) and np.array_equal(got["rgbs"], want["rgbs"])
    assert _dicts_equal(got["validation"], want["validation"])
    assert out_port.getvalue().replace("port.json", "jax.json") == out_jax.getvalue()
    stats = got["stages"]
    assert set(stats) == {"read", "outlier_filter", "knn", "normalize_convert", "aabb", "points_read",
                          "points_kept"}
    assert stats["points_read"] == len(got["points"]) and 0 < stats["points_kept"] < stats["points_read"]
    assert 0.0 < stats["knn"] <= stats["outlier_filter"]


def test_scene_aabb_and_validation_equal():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.3, 1.2, size=(3000, 3))
    adjust = {"aabb_min": [0.1, 0, -0.2], "aabb_max": [0, -0.1, 0.05]}
    for keys in ({}, {"remove_below_aabb": False, "remove_upper_aabb": False}):
        cfg = JaxConfigNode(keys)
        with contextlib.redirect_stdout(io.StringIO()):
            got = convert.compute_scene_aabb(pts, adjust, cfg=ConfigNode(keys))
            want = jconvert.compute_scene_aabb(pts, adjust, cfg=cfg)
        assert _dicts_equal(got, want)
    frames = [{"transform_matrix": np.linalg.qr(rng.normal(size=(4, 4)))[0].tolist()} for _ in range(6)]
    with contextlib.redirect_stdout(io.StringIO()):
        assert _dicts_equal(convert.validate_camera_orientations(frames, pts),
                            jconvert.validate_camera_orientations(frames, pts))
    R = convert.euler_world_rotation([30, 45, -60], [1, 2, 0], np.eye(3) * 2)
    assert np.array_equal(R, jconvert.euler_world_rotation([30, 45, -60], [1, 2, 0], np.eye(3) * 2))


def test_colmap2nerf_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """colmap_to_nerf takes no default device, and the CLI's is the card:
    without one, both raise before reading the model."""
    import inspect

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for fn in (convert.colmap_to_nerf, convert.resolve_normalization, normalize.scene_normalization):
        assert inspect.signature(fn).parameters["device"].default is inspect.Parameter.empty
    _, cfg, _ = _scene("ring", tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.colmap_to_nerf(cfg, device="cuda", verbose=False)
    _write_cfg(tmp_path, {"scene_name": "s", "colmap_dir": str(tmp_path / "data" / "s")})
    with pytest.raises(RuntimeError, match="cuda"):
        _main("nerfjax_torch.cli.colmap2nerf", ["--cfg_path", "cfg.json"], monkeypatch, tmp_path)
    assert not (tmp_path / "transforms_s.json").exists()


def test_colmap_exports_match_nerfjax():
    import nerfjax.colmap as jcolmap

    assert port_colmap.__all__ == jcolmap.__all__
    for name in port_colmap.__all__:
        assert getattr(port_colmap, name).__module__.startswith("nerfjax_torch.colmap")


# -- images -------------------------------------------------------------------------


def _raw_images(root: Path) -> Path:
    from PIL import Image

    rng = np.random.default_rng(4)
    root.mkdir(parents=True)
    Image.fromarray(rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)).save(root / "a.png")
    Image.fromarray(rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)).save(root / "b.jpg", quality=90)
    Image.fromarray(rng.integers(0, 256, (33, 47, 4), dtype=np.uint8)).save(root / "c.PNG")
    (root / "notes.txt").write_text("not an image")
    return root


@pytest.mark.parametrize("resize", [True, False])
def test_process_images_byte_equal(tmp_path, resize):
    src = _raw_images(tmp_path / "raw")
    with contextlib.redirect_stdout(io.StringIO()) as out_port:
        n = images.process_images(src, tmp_path / "port", new_size=(32, 24), resize=resize)
    with contextlib.redirect_stdout(io.StringIO()) as out_jax:
        jn = jimages.process_images(src, tmp_path / "jax", new_size=(32, 24), resize=resize)
    assert n == jn == 3
    assert out_port.getvalue().replace("/port", "/jax") == out_jax.getvalue()
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


# -- the COLMAP driver ---------------------------------------------------------------


@pytest.fixture()
def stub_colmap(tmp_path, monkeypatch):
    """A stand-in 'colmap' on PATH that logs its argv and exits with the code
    in <tmp>/rc (0 unless a test writes one)."""
    log = tmp_path / "calls.log"
    script = tmp_path / "bin" / "colmap"
    script.parent.mkdir()
    script.write_text(f'#!/bin/sh\necho "$@" >> "{log}"\nexit $(cat "{tmp_path / "rc"}" 2>/dev/null || echo 0)\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{script.parent}:/usr/bin:/bin")
    return log


def _argv_log(log: Path, fn, ws: Path, **kw) -> list[str]:
    log.unlink(missing_ok=True)
    with contextlib.redirect_stdout(io.StringIO()):
        fn(ws, **kw)
    return log.read_text().splitlines()


@pytest.mark.parametrize("matcher", ["exhaustive", "sequential", "vocab_tree"])
@pytest.mark.parametrize("gpu", [False, True])
def test_run_colmap_same_argv(tmp_path, stub_colmap, matcher, gpu):
    ws = tmp_path / "scene"
    (ws / "images").mkdir(parents=True)
    kw = {"matcher": matcher, "gpu": gpu, "camera_model": "OPENCV", "single_camera": gpu}
    got = _argv_log(stub_colmap, driver.run_colmap, ws, **kw)
    want = _argv_log(stub_colmap, jdriver.run_colmap, ws, **kw)
    assert got == want and len(got) == 5
    assert driver.run_colmap(ws, verbose=False, image_dir=tmp_path) == jdriver.run_colmap(
        ws, verbose=False, image_dir=tmp_path)


def test_run_colmap_fails_loudly_like_nerfjax(tmp_path, stub_colmap, monkeypatch):
    (tmp_path / "rc").write_text("3")
    ws = tmp_path / "scene"
    (ws / "images").mkdir(parents=True)
    with pytest.raises(SystemExit) as got:
        driver.run_colmap(ws, verbose=False)
    with pytest.raises(SystemExit) as want:
        jdriver.run_colmap(ws, verbose=False)
    assert str(got.value.code) == str(want.value.code) and "feature_extractor" in str(got.value.code)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for fn in (driver.find_colmap, jdriver.find_colmap):
        with pytest.raises(FileNotFoundError):
            fn()
        with pytest.raises(FileNotFoundError):
            fn("/nowhere/colmap")


# -- the CLIs ----------------------------------------------------------------------


def _main(module: str, args: list[str], monkeypatch, cwd: Path) -> str:
    """``python -m module args`` in this process, in cwd; its stdout."""
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [module, *args])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        runpy.run_module(module, run_name="__main__", alter_sys=False)
    return out.getvalue()


def _two_sides(tmp_path: Path, make) -> dict[str, Path]:
    """The same inputs in <tmp>/port and <tmp>/jax (relative paths in the cfg)."""
    roots = {}
    for side in ("port", "jax"):
        roots[side] = tmp_path / side
        roots[side].mkdir()
        make(roots[side])
    return roots


def _tree(root: Path, skip=("cfg.json",)) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and p.name not in skip}


def _write_cfg(root: Path, keys: dict) -> str:
    import json

    (root / "cfg.json").write_text(json.dumps(keys))
    return str(root / "cfg.json")


@pytest.mark.parametrize("mode", ["auto", "euler"])
def test_colmap2nerf_cli_matches_nerfjax(tmp_path, monkeypatch, mode):
    def make(root):
        _make_colmap_scene(root)
        _write_cfg(root, {"scene_name": "s", "colmap_dir": "data/s", "scale": 0.9})

    roots = _two_sides(tmp_path, make)
    got = _main("nerfjax_torch.cli.colmap2nerf", ["--cfg_path", "cfg.json", "--mode", mode, "--device", "cpu"],
                monkeypatch, roots["port"])
    want = _main("nerfjax.cli.colmap2nerf", ["--cfg_path", "cfg.json", "--mode", mode], monkeypatch, roots["jax"])
    lines = got.splitlines()
    assert lines[-1].startswith("Stages: ") and "\n".join(lines[:-1]) + "\n" == want
    assert _tree(roots["port"]) == _tree(roots["jax"])
    import json

    st = json.loads(lines[-1][len("Stages: "):])
    assert set(st) >= {"read", "outlier_filter", "knn", "normalize_convert", "aabb", "write", "wall",
                       "points_read", "points_kept"}
    assert st["points_read"] == 500 and st["points_kept"] < 500


def test_resize_images_cli_matches_nerfjax(tmp_path, monkeypatch):
    def make(root):
        _raw_images(root / "raw")
        _write_cfg(root, {"scene_name": "s", "workspace": "ws", "image_dir": "raw", "tmp_image_dir": "small",
                          "resize_images": True, "newSize": [20, 16]})

    roots = _two_sides(tmp_path, make)
    got = _main("nerfjax_torch.cli.resize_images", ["--cfg_path", "cfg.json"], monkeypatch, roots["port"])
    want = _main("nerfjax.cli.resize_images", ["--cfg_path", "cfg.json"], monkeypatch, roots["jax"])
    assert got == want
    assert _tree(roots["port"]) == _tree(roots["jax"]) and len(list((roots["port"] / "small").iterdir())) == 3


@pytest.mark.parametrize("no_rotate", [False, True])
def test_transform_colmap_cli_matches_nerfjax(tmp_path, monkeypatch, no_rotate):
    def make(root):
        _make_adversarial_scene(root)
        _write_cfg(root, {"scene_name": "adv", "colmap_dir": "data/adv"})

    roots = _two_sides(tmp_path, make)
    flags = ["--cfg_path", "cfg.json"] + (["--no_rotate"] if no_rotate else [])
    got = _main("nerfjax_torch.cli.transform_colmap", flags, monkeypatch, roots["port"])
    want = _main("nerfjax.cli.transform_colmap", flags, monkeypatch, roots["jax"])
    assert got == want
    assert _tree(roots["port"]) == _tree(roots["jax"])


def test_run_colmap_cli_matches_nerfjax(tmp_path, monkeypatch, stub_colmap):
    def make(root):
        (root / "imgs").mkdir()
        _write_cfg(root, {"scene_name": "s", "workspace": "ws", "image_dir": "imgs", "colmap_dir": "col"})

    roots = _two_sides(tmp_path, make)
    flags = ["--cfg_path", "cfg.json", "--matcher", "sequential", "--gpu"]
    got = _main("nerfjax_torch.cli.run_colmap", flags, monkeypatch, roots["port"])
    calls_port = stub_colmap.read_text()
    stub_colmap.unlink()
    want = _main("nerfjax.cli.run_colmap", flags, monkeypatch, roots["jax"])
    assert got == want and calls_port == stub_colmap.read_text()
    assert _tree(roots["port"]) == _tree(roots["jax"])


def test_scene_viewer_helpers_match_nerfjax():
    lo, hi = np.array([-0.5, -1.0, 0.25]), np.array([0.75, 1.0, 0.5])
    got, want = viewers._box_edges(lo, hi), jviewers._box_edges(lo, hi)
    assert len(got) == len(want) == 12
    for (a, b), (c, d) in zip(got, want):
        assert np.array_equal(a, c) and np.array_equal(b, d)


def test_display_scene_draws_like_nerfjax(monkeypatch):
    """display_scene on matplotlib's Agg backend (plt.show a no-op): the
    same artists as nerfjax's."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "show", lambda: None)
    rng = np.random.default_rng(6)
    pts, rgbs = rng.normal(size=(300, 3)), rng.uniform(size=(300, 3))
    frames = [{"transform_matrix": np.eye(4).tolist()}, {"transform_matrix": np.diag([1.0, -1, -1, 1]).tolist()}]
    aabb = {"aabb_min": [-1, -1, -0.5], "aabb_max": [1, 1, 0.8]}
    counts = []
    for fn in (viewers.display_scene, jviewers.display_scene):
        fn(pts, rgbs, frames, aabb)
        ax = plt.gcf().axes[0]
        counts.append((len(ax.collections), len(ax.lines)))
        plt.close("all")
    assert counts[0] == counts[1] == (3, 14)
