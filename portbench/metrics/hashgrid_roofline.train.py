"""The hash-grid kernels' roofline share in the training window: the bound
of every step's encode and table gradient (``work.train_hash_bound_s``,
at the table entries the reference's first checked step touches) over the
summed device time of the kernels named in ``HASH_KERNELS``."""

from portbench import work

HASH_KERNELS = ("hash_levels_", "dense_levels_", "pack_pairs", "table_grad_scatter", "scratch_fold", "hashgrid_")


def read(run):
    if run.dtrace is None or "entries" not in run.extra:
        return None
    busy = run.dtrace.kernel_s(*HASH_KERNELS)
    bound = work.train_hash_bound_s(run.cfg, run.units["steps"], run.extra["entries"])
    return 100.0 * bound / busy if busy > 0 else None
