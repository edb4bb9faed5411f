"""The training window's model FLOPs (forward and backward of every
sample, ``work.train_step_flops``) over its seconds, as a share of the
bf16 dense peak."""

from portbench import work


def read(run):
    steps, t = run.units.get("steps"), run.units.get("window_s")
    if not steps or run.dtrace is None:
        return None
    return 100.0 * work.train_step_flops(run.cfg) * steps / t / work.PEAK_BF16
