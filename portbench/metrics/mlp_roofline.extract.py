"""The fused MLP kernels' roofline share in the extraction window: the
density head's bound at the coarse points and the head's at the fine
points (``work.head_bound_s``) over the summed device time of the kernels
named in ``MLP_KERNELS``."""

from portbench import work

MLP_KERNELS = ("ngp_head", "ngp_density")


def read(run):
    md = run.extra.get("metadata")
    if not md or run.dtrace is None:
        return None
    busy = run.dtrace.kernel_s(*MLP_KERNELS)
    C, E = int(run.traffic["resolution"]) // 4, 2 * int(run.cfg.get("hash_n_levels", 16))
    bound = sum(work.head_bound_s(C**3, E, density_only=True) + work.head_bound_s(64 * m["marked_cells"], E)
                for m in md)
    return 100.0 * bound / busy if busy > 0 else None
