"""Vanilla NeRF field (counterpart of ``nerfjax/fields/vanilla.py``): the
reference's 8 x 256 skip-MLP.

Four ReLU layers on the Fourier-encoded position, the encoding concatenated
back in (the skip), four more; a density head (weight N(0, 0.01^2), bias
0.1) with train-time Gaussian noise on sigma before its ReLU; a feature
layer, then [features, encoded direction] -> 128 -> ReLU -> 3 -> sigmoid.

``VanillaNeRF`` is an ``nn.Module`` holding nerfjax's parameter layout:
``w`` [in, out] and ``b`` [out] per layer, in the same nesting
(``params()``, ``load_params``). ``query_density``/``apply`` are nerfjax's
point-major forward (:89-137): ``x @ w + b`` on [N, C] activations in the
weights' dtype. Its feature-major methods keep nerfjax's
names and arithmetic: every weight and bias cast to ``dtype``, the product
in ``dtype`` (``jnp.dot(w.T.astype(dtype), h, preferred_element_type=dtype)
+ b``). Its products are plain ``torch.matmul``: nerfjax computes them
outside any kernel too. ``apply_planar_fused`` and
``query_density_planar_fused`` are the inference entry points the render and
the extraction call on any field; here they are the unfused path without
gradient (there is no fused vanilla kernel).

The noise: nerfjax draws ``jax.random.normal(rng, sigma.shape)``; here it is
an injected tensor ``noise`` (the parity tests pass nerfjax's draws) or a
draw from ``generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nerfjax_torch.fields.encodings import fourier_encode, fourier_encode_planar, fourier_output_dim

N_POS, N_SKIP = 4, 4


class _Linear(nn.Module):
    """One layer in nerfjax's layout: x @ w + b, w [in, out]."""

    def __init__(self, fan_in: int, fan_out: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out, device=device), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(fan_out, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, in] -> [N, out] in the weights' dtype."""
        return torch.matmul(x, self.w) + self.b

    def planar(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[in, N] -> [out, N] in ``dtype``."""
        return torch.matmul(self.w.T.to(dtype), h) + self.b.to(dtype)[:, None]

    def params(self) -> dict:
        return {"w": self.w, "b": self.b}


class VanillaNeRF(nn.Module):
    def __init__(self, pos_L: int = 10, dir_L: int = 4, hidden_dim: int = 256, include_input_pos: bool = True,
                 include_input_dir: bool = True, sigma_noise: bool = True, device="cpu"):
        super().__init__()
        self.pos_L, self.dir_L, self.hidden_dim = int(pos_L), int(dir_L), int(hidden_dim)
        self.include_input_pos, self.include_input_dir = include_input_pos, include_input_dir
        self.sigma_noise = sigma_noise
        h, dev = self.hidden_dim, torch.device(device)
        self.pos_layers = nn.ModuleList([_Linear(self.pos_dim if i == 0 else h, h, dev) for i in range(N_POS)])
        self.skip_layers = nn.ModuleList([_Linear(h + self.pos_dim if i == 0 else h, h, dev) for i in range(N_SKIP)])
        self.density = _Linear(h, 1, dev)
        self.feature = _Linear(h, h, dev)
        self.color_layers = nn.ModuleList([_Linear(h + self.dir_dim, h // 2, dev), _Linear(h // 2, 3, dev)])

    @property
    def pos_dim(self) -> int:
        return fourier_output_dim(self.pos_L, self.include_input_pos)

    @property
    def dir_dim(self) -> int:
        return fourier_output_dim(self.dir_L, self.include_input_dir)

    def _layers(self):
        return [*self.pos_layers, *self.skip_layers, self.density, self.feature, *self.color_layers]

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "VanillaNeRF":
        """torch.nn.Linear's default: w and b ~ U(-1/sqrt(fan_in),
        1/sqrt(fan_in)); the density head's w ~ 0.01 N(0, 1), b = 0.1.
        Drawn on the CPU from ``generator`` (its numbers are not
        jax.random's)."""
        for layer in self._layers():
            fan_in, fan_out = layer.w.shape
            if layer is self.density:
                layer.w.copy_(0.01 * torch.randn(fan_in, fan_out, generator=generator))
                layer.b.fill_(0.1)
                continue
            bound = 1.0 / math.sqrt(fan_in)
            layer.w.copy_(torch.rand(fan_in, fan_out, generator=generator) * (2 * bound) - bound)
            layer.b.copy_(torch.rand(fan_out, generator=generator) * (2 * bound) - bound)
        return self

    def params(self) -> dict:
        """nerfjax's nested param dict of this field's parameters."""
        return {
            "pos_layers": [layer.params() for layer in self.pos_layers],
            "skip_layers": [layer.params() for layer in self.skip_layers],
            "density": self.density.params(),
            "feature": self.feature.params(),
            "color_layers": [layer.params() for layer in self.color_layers],
        }

    @torch.no_grad()
    def load_params(self, params: dict) -> "VanillaNeRF":
        """Copy a nerfjax-layout param dict of tensors into the field."""
        mine = self.params()
        for name in ("pos_layers", "skip_layers", "color_layers"):
            if len(params[name]) != len(mine[name]):
                raise ValueError(f"{name}: {len(params[name])} layers, expected {len(mine[name])}")
        for name, layers in mine.items():
            for ours, theirs in zip(layers if isinstance(layers, list) else [layers],
                                    params[name] if isinstance(layers, list) else [params[name]]):
                for key in ("w", "b"):
                    if tuple(theirs[key].shape) != tuple(ours[key].shape):
                        raise ValueError(f"{name}.{key}: shape {tuple(theirs[key].shape)}, "
                                         f"expected {tuple(ours[key].shape)}")
                    ours[key].copy_(theirs[key])
        return self

    def num_params(self) -> int:
        """The parameters' element count."""
        return sum(p.numel() for p in self.parameters())

    @staticmethod
    def _noisy(sigma: torch.Tensor, noise, generator) -> torch.Tensor:
        """sigma plus the train-time noise of its shape: ``noise`` (any
        shape of as many elements), or a draw from ``generator``."""
        if noise is None:
            noise = torch.randn(sigma.shape, generator=generator, device=sigma.device, dtype=sigma.dtype)
        return sigma + noise.reshape(sigma.shape).to(sigma.dtype)

    # -- the point-major path: positions and directions as [N, 3] ----------

    def query_density(self, pos: torch.Tensor, *, train: bool = False, noise=None, generator=None):
        """pos [N, 3] -> (sigma [N, 1], features [N, hidden]). With ``train``
        and ``sigma_noise`` the pre-ReLU sigma gets ``noise`` [N, 1] (nerfjax's
        ``rng`` draw), drawn from ``generator`` when None."""
        pe = fourier_encode(pos, self.pos_L, self.include_input_pos)
        x = pe
        for layer in self.pos_layers:
            x = torch.relu(layer(x))
        x = torch.cat([x, pe], dim=-1)
        for layer in self.skip_layers:
            x = torch.relu(layer(x))
        sigma = self.density(x)
        if train and self.sigma_noise:
            sigma = self._noisy(sigma, noise, generator)
        return torch.relu(sigma), self.feature(x)

    def apply(self, pos: torch.Tensor, view: torch.Tensor, *, train: bool = False, noise=None, generator=None):
        """pos, view [N, 3] -> (rgb [N, 3], sigma [N, 1])."""
        sigma, features = self.query_density(pos, train=train, noise=noise, generator=generator)
        x = torch.cat([features, fourier_encode(view, self.dir_L, self.include_input_dir)], dim=-1)
        for layer in self.color_layers[:-1]:
            x = torch.relu(layer(x))
        return torch.sigmoid(self.color_layers[-1](x)), sigma

    # -- feature-major paths: positions/directions as three [N] vectors,
    # activations as [C, N] -------------------------------------------------

    def query_density_planar(self, pos3, *, dtype=torch.float32, train: bool = False, noise=None, generator=None):
        """(px, py, pz) [N] -> (sigma [N], features [hidden, N]). With
        ``train`` and ``sigma_noise`` the pre-ReLU sigma gets ``noise`` [N]
        (drawn from ``generator`` when None)."""
        pe = fourier_encode_planar(*pos3, self.pos_L, self.include_input_pos).to(dtype)
        h = pe
        for layer in self.pos_layers:
            h = torch.relu(layer.planar(h, dtype))
        h = torch.cat([h, pe], dim=0)
        for layer in self.skip_layers:
            h = torch.relu(layer.planar(h, dtype))
        sigma = self.density.planar(h, dtype)[0]
        if train and self.sigma_noise:
            sigma = self._noisy(sigma, noise, generator)
        return torch.relu(sigma), self.feature.planar(h, dtype)

    def apply_planar(self, pos3, view3, *, dtype=torch.float32, train: bool = False, noise=None, generator=None):
        """Feature-major forward -> (rgb [3, N], sigma [N])."""
        sigma, features = self.query_density_planar(pos3, dtype=dtype, train=train, noise=noise,
                                                    generator=generator)
        de = fourier_encode_planar(*view3, self.dir_L, self.include_input_dir).to(dtype)
        h = torch.cat([features, de], dim=0)
        for layer in self.color_layers[:-1]:
            h = torch.relu(layer.planar(h, dtype))
        return torch.sigmoid(self.color_layers[-1].planar(h, dtype)), sigma

    @torch.no_grad()
    def apply_planar_fused(self, pos3, view3, *, dtype=torch.float32):
        """The inference forward (no noise, no gradient)."""
        return self.apply_planar(pos3, view3, dtype=dtype)

    @torch.no_grad()
    def query_density_planar_fused(self, pos3, *, dtype=torch.float32) -> torch.Tensor:
        """sigma [N] of the inference forward."""
        return self.query_density_planar(pos3, dtype=dtype)[0]
