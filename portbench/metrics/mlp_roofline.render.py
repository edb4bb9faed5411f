"""The fused MLP head's roofline share in the rendering window: the head's
bound at both passes' points of the hit rays (``work.head_bound_s``) over
the summed device time of the kernels named in ``MLP_KERNELS``."""

from portbench import work

MLP_KERNELS = ("ngp_head", "ngp_density")


def read(run):
    if run.dtrace is None:
        return None
    busy = run.dtrace.kernel_s(*MLP_KERNELS)
    rays, E = run.units["hit_rays"], 2 * int(run.cfg.get("hash_n_levels", 16))
    s, i = int(run.cfg.get("N_samples", 64)), int(run.cfg.get("N_importance", 128))
    bound = work.head_bound_s(rays * s, E) + work.head_bound_s(rays * (s + i), E)
    return 100.0 * bound / busy if busy > 0 else None
