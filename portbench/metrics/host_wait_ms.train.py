"""Host ms blocked on the card a training step: every ``wait.*`` span of
the window (the feed's slot waits included) per ``train.step`` span."""


def read(run):
    try:
        from nerfjax_torch import tracing
    except ImportError:  # a program without its spans
        return None
    s = tracing.summarize(*((run.dtrace.t0, run.dtrace.t1) if run.dtrace is not None else ()))
    n = s.get("train.step", {}).get("n", 0)
    return 1e-6 * sum(v["ns"] for k, v in s.items() if k.startswith("wait.")) / n if n else None
