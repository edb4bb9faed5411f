"""Faults planted in the program underneath the harness, which a cell's
check has to catch: a step that returns its state unchanged, half the
batch left out with the mean over the rest, an answer altered where it is
produced, answers lost on their way to the host.

Each fault takes ``patch(module, name, value)`` (pytest's
``monkeypatch.setattr``, or ``Patches`` below) and swaps one function of
the program. A kind lists the faults its check has to catch in its own
``FAULTS`` (``portbench/kinds/<kind>.py``); the tests and ``calibrate.py``
plant those. A new kind may define its own faults, in its module or in a
new file."""

from __future__ import annotations

import torch


class Patches:
    """``patch(module, name, value)`` that ``undo()`` takes back."""

    def __init__(self):
        self.saved: list = []

    def __call__(self, module, name: str, value) -> None:
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def undo(self) -> None:
        while self.saved:
            module, name, value = self.saved.pop()
            setattr(module, name, value)


def unchanged(patch) -> None:
    from nerfjax_torch import train

    def no_update(state):
        state.step += 1

    patch(train, "apply_gradients", no_update)


def half_batch(patch) -> None:
    from nerfjax_torch import train

    real = train.loss_fn

    def half(field, batch, settings, occ_grid, **kw):
        B = batch["rays_o"].shape[0] // 2
        kw = {k: (v[: v.shape[0] // 2] if torch.is_tensor(v) else v) for k, v in kw.items()}
        return real(field, {k: v[:B] for k, v in batch.items()}, settings, occ_grid, **kw)

    patch(train, "loss_fn", half)


def altered_frame(patch) -> None:
    from nerfjax_torch import render_image

    real, calls = render_image.render_rays_planar, [0]

    def altered(*a, **kw):
        out = real(*a, **kw)
        calls[0] += 1
        if calls[0] % 3 == 0:
            out = {**out, "rgb_fine": 1.0 - out["rgb_fine"]}
        return out

    patch(render_image, "render_rays_planar", altered)


def altered_volume(patch) -> None:
    from nerfjax_torch import extract

    real = extract._to_u8
    patch(extract, "_to_u8", lambda rgb: real(rgb).flip(1).contiguous())


def dropped_voxels(patch) -> None:
    """The fetch loses every other occupied voxel (occupancy and color)."""
    from nerfjax_torch import extract

    real = extract._fetch_volumes

    def lossy(*a, **kw):
        occ, rgb, sparse_used, rgb_max = real(*a, **kw)
        occ, rgb = occ.copy(), rgb.copy()
        lost = occ.reshape(-1).nonzero()[0][::2]
        occ.reshape(-1)[lost] = 0
        rgb.reshape(-1, 3)[lost] = 0
        return occ, rgb, sparse_used, rgb_max

    patch(extract, "_fetch_volumes", lossy)

