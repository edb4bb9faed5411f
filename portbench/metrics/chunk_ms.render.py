"""Mean host ms of one render chunk (``render_image``'s ``render.chunk``
span: its draws, the coarse and fine passes, the pdf and the composites
enqueued), over the traced window."""


def read(run):
    try:
        from nerfjax_torch import tracing
    except ImportError:  # a program without its spans
        return None
    s = tracing.summarize(*((run.dtrace.t0, run.dtrace.t1) if run.dtrace is not None else ()))
    n = s.get("render.chunk", {}).get("n", 0)
    return 1e-6 * s["render.chunk"]["ns"] / n if n else None
