"""Mean seconds a volume spends marking the cells for the fine pass
(Otsu on the cells, their copy to the host, the dilation, ``argwhere`` and
its upload: ``extract.mark``) per ``extract.volume`` span."""


def read(run):
    try:
        from nerfjax_torch import tracing
    except ImportError:  # a program without its spans
        return None
    s = tracing.summarize(*((run.dtrace.t0, run.dtrace.t1) if run.dtrace is not None else ()))
    n = s.get("extract.volume", {}).get("n", 0)
    return 1e-9 * s.get("extract.mark", {}).get("ns", 0) / n if n else None
