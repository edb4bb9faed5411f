"""nerfjax_torch — the PyTorch/CUDA port of nerfjax for one NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. It runs nerfjax's chain: images -> resize
(``cli.resize_images``) -> COLMAP (``cli.run_colmap``) -> transforms JSON
(``cli.colmap2nerf``, ``cli.transform_colmap``) -> ray NPZ
(``cli.precompute_rays``) -> training (``cli.train``) -> hierarchical
volume extraction (``cli.extract_vol``) -> sliced points and tif/vti
(``cli.post_process_vol``, ``cli.write_format``), and held-out rendering
(``cli.render``, ``cli.eval_psnr``). Its kernels are written by hand in CUDA
C++ for ``sm_90a`` under ``nerfjax_torch/csrc``: the fused MLP heads
(``fused_mlp.cu``), the hash-grid encode and its gradients
(``hash_encode.cu``), the lowering probes (``micro_probe.cu``) and the
outlier filter's kNN (``knn.cu``).

Module names mirror nerfjax's so each counterpart is easy to find. The
package imports torch and nothing of nerfjax or jax: it keeps its own copy
of what it needs (``config``, ``postprocess``, ``gui.viewers``,
``colmap``, ``utils``) and reads and writes nerfjax's ``.pth`` formats with
``torch.save``/``torch.load``.
"""

__version__ = "0.1.0"
