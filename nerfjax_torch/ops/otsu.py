"""Otsu threshold as an on-device histogram (counterpart of ``nerfjax/ops/otsu.py``).

256 bins over [min, max]; the threshold is the center of the bin that
maximises the between-class variance (skimage's bin-center convention).

One deliberate difference: nerfjax counts the histogram in float32
(otsu.py:28), whose additions stop at 2^24 per bin; at 512^3 the empty bin
holds more than that. Here the counts are int64 and the between-class
variance is float64, as in skimage: with ~10^8 voxels in one bin, float32
sums of the class weights and means move the argmax of that flat curve by
a few bins. The bins, their centers and the returned threshold are float32
as in nerfjax, and below 2^24 per bin the two agree.
"""

from __future__ import annotations

import torch

from nerfjax_torch import tracing

NBINS = 256


def otsu_threshold(values: torch.Tensor) -> torch.Tensor:
    """Scalar float32 Otsu threshold of a flattened tensor, on its device."""
    v = values.reshape(-1).to(torch.float32)
    vmin = v.min()
    vmax = v.max()
    span = torch.clamp_min(vmax - vmin, 1e-12)

    bin_idx = ((v - vmin) / span * NBINS).to(torch.int64).clamp(0, NBINS - 1)
    with tracing.span("wait.otsu_hist"):  # on a card bincount reads the largest index on the host
        hist = torch.bincount(bin_idx, minlength=NBINS).to(torch.float64)

    bin_width = span / NBINS
    centers = vmin + (torch.arange(NBINS, dtype=torch.float32, device=v.device) + 0.5) * bin_width

    # between-class variance of every split (skimage formulation)
    mass = hist * centers.to(torch.float64)
    w1 = torch.cumsum(hist, 0)
    w2 = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
    m1 = torch.cumsum(mass, 0) / torch.clamp_min(w1, 1e-12)
    m2 = torch.flip(
        torch.cumsum(torch.flip(mass, [0]), 0) / torch.clamp_min(torch.flip(w2, [0]), 1e-12),
        [0],
    )
    var12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    with tracing.span("wait.otsu_argmax"):  # indexing by a tensor reads the index on the host
        return centers[torch.argmax(var12)]
