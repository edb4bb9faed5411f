"""nerfjax_torch's double-buffered batch feed on the CPU: the batches and
their order are epoch_batches', and train() fed through it ends in the
state that the same batches fed by batch_to_device give."""

from pathlib import Path

import numpy as np
import pytest

from nerfjax_torch import data as D
from nerfjax_torch.train import train
from tests.synthetic import make_ray_npz

TINY = {
    "ngp": True, "nerf_type": "small", "hash_n_levels": 8, "hash_extra_dense_levels": 1,
    "batch_size": 128, "num_epochs": 2, "lr": 5e-3, "N_samples": 8, "N_importance": 16,
    "precision": "bf16", "occupancy_grid": True, "single_pass": True,
    "hash_grad_corners": 1, "hash_fwd_corners": 1, "hash_grad_levels": 2,
    "occ_resolution": 16, "occ_update_every": 2, "occ_update_partitions": 4,
    "occ_fast_cdf": True, "occ_segments": 8,
}


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("rays") / "rays.npz"
    make_ray_npz(path, n_rays=300, seed=4)
    return path


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_yields_the_epoch_batches_in_order(npz, depth):
    ds = D.RayDataset(npz, verbose=False)
    want = list(ds.epoch_batches(64, seed=3))
    got = list(D.prefetch_to_device(ds.epoch_batches(64, seed=3), "cpu", depth=depth))
    assert len(got) == len(want) == 300 // 64
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].device.type == "cpu" and g[k].dtype == D.torch.float32
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def _cfg(tmp_path: Path, npz: Path) -> dict:
    out = tmp_path / "out"
    return {**TINY, "rays_file": str(npz), "output_dir": str(out), "checkpoint_dir": str(out / "ckpt")}


def test_train_through_the_prefetch_equals_batch_to_device(npz, tmp_path, monkeypatch):
    """Two epochs of train() on the CPU: fed by prefetch_to_device (what
    train() does) and by batch_to_device, one batch at a time, the final
    parameters are equal."""
    fed = train(_cfg(tmp_path / "a", npz), device="cpu", log_every=1000)
    seen = []

    def plain(iterator, device, depth=2):
        for batch in iterator:
            seen.append(batch["rays_o"].copy())
            yield D.batch_to_device(batch, device)

    monkeypatch.setattr(D, "prefetch_to_device", plain)
    ref = train(_cfg(tmp_path / "b", npz), device="cpu", log_every=1000)
    assert fed["steps"] == ref["steps"] == len(seen) == 4
    np.testing.assert_array_equal(np.asarray(fed["psnr"]), np.asarray(ref["psnr"]))
    np.testing.assert_array_equal(np.asarray(fed["params"]["table"]), np.asarray(ref["params"]["table"]))
    for name in ("dmlp", "cmlp"):
        for x, y in zip(fed["params"][name], ref["params"][name]):
            np.testing.assert_array_equal(np.asarray(x["w"]), np.asarray(y["w"]))
