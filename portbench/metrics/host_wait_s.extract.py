"""Seconds a volume blocks the host on the card: every ``wait.*`` span of
the window (the phase clock's ``wait.phase`` included) per
``extract.volume`` span."""


def read(run):
    try:
        from nerfjax_torch import tracing
    except ImportError:  # a program without its spans
        return None
    s = tracing.summarize(*((run.dtrace.t0, run.dtrace.t1) if run.dtrace is not None else ()))
    n = s.get("extract.volume", {}).get("n", 0)
    return 1e-9 * sum(v["ns"] for k, v in s.items() if k.startswith("wait.")) / n if n else None
