"""The extraction window's model FLOPs (the density MLP at every coarse
point, the whole MLP at every fine point; the marked cells from the
program's own count) over its seconds, as a share of the bf16 dense peak."""

from portbench import work


def read(run):
    md, t = run.extra.get("metadata"), run.units.get("window_s")
    if not md or run.dtrace is None:
        return None
    C = int(run.traffic["resolution"]) // 4
    flops = sum(work.extract_flops(run.cfg, C**3, 64 * m["marked_cells"]) for m in md)
    return 100.0 * flops / t / work.PEAK_BF16
