"""The hash-grid kernels' roofline share in the rendering window: the bound
of both passes' encode at the hit rays (``work.render_hash_bound_s``, the
table entries at the rate a hit ray of the checked frame's chunks touches
them) over the summed device time of the kernels named in
``HASH_KERNELS``."""

from portbench import work

HASH_KERNELS = ("hash_levels_", "dense_levels_", "pack_pairs", "table_grad_scatter", "scratch_fold", "hashgrid_")


def read(run):
    if run.dtrace is None or "entries_per_ray" not in run.extra:
        return None
    busy = run.dtrace.kernel_s(*HASH_KERNELS)
    rays = run.units["hit_rays"]
    bound = work.render_hash_bound_s(run.cfg, rays, rays * run.extra["entries_per_ray"])
    return 100.0 * bound / busy if busy > 0 else None
