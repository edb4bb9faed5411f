"""nerfjax_torch — the PyTorch/CUDA port of nerfjax for one NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. Its first slice is the served path:
a trained checkpoint -> hierarchical volume extraction -> ``volume.pth``
(``python -m nerfjax_torch.cli.extract_vol``). The two fused MLP kernels of
that path (``nerfjax/ops/pallas_mlp.py``) are written by hand in CUDA C++
for ``sm_90a`` (``nerfjax_torch/csrc/fused_mlp.cu``).

Module names mirror nerfjax's so each counterpart is easy to find. The
package imports torch and never jax; it reuses the jax-free
``nerfjax.pth`` (and ``nerfjax.config`` in the CLI only).
"""

__version__ = "0.1.0"
