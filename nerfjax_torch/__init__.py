"""nerfjax_torch — the PyTorch/CUDA port of nerfjax for one NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. Two slices are ported: the served path, a
trained checkpoint -> hierarchical volume extraction -> ``volume.pth``
(``python -m nerfjax_torch.cli.extract_vol``), and the training path, a ray
NPZ -> the tuned single-pass NGP train step -> checkpoints
(``python -m nerfjax_torch.cli.train``). Their kernels are written by hand
in CUDA C++ for ``sm_90a``: the fused MLP heads
(``nerfjax_torch/csrc/fused_mlp.cu``) and the hashed-level encode, its
table gradient and the table-gradient scatter
(``nerfjax_torch/csrc/hash_encode.cu``).

Module names mirror nerfjax's so each counterpart is easy to find. The
package imports torch and nothing of nerfjax or jax: it keeps its own copy
of what it needs (``config``, ``postprocess``, ``gui.viewers``) and reads
and writes nerfjax's ``.pth`` formats with ``torch.save``/``torch.load``.
"""

__version__ = "0.1.0"
