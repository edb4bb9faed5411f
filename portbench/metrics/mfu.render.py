"""The rendering window's model FLOPs (the forward of every sample of the
rays that hit the cube, ``work.render_flops``) over its seconds, as a
share of the bf16 dense peak."""

from portbench import work


def read(run):
    rays, t = run.units.get("hit_rays"), run.units.get("window_s")
    if not rays or run.dtrace is None:
        return None
    return 100.0 * work.render_flops(run.cfg, rays) / t / work.PEAK_BF16
