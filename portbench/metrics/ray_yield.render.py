"""The share of the rays rendered that hit the cube: the ``render.frame``
spans' counts, hit rays over the padded chunks' rays, over the traced
window."""


def read(run):
    try:
        from nerfjax_torch import tracing
    except ImportError:  # a program without its spans
        return None
    s = tracing.summarize(*((run.dtrace.t0, run.dtrace.t1) if run.dtrace is not None else ()))
    counts = s.get("render.frame", {}).get("counts", {})
    return 100.0 * counts["hit_rays"] / counts["rays"] if counts.get("rays") else None
