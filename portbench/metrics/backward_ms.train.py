"""Mean host ms of a training step's backward (``total.backward()``,
``train.backward``) per ``train.step`` span, over the traced window."""


def read(run):
    try:
        from nerfjax_torch import tracing
    except ImportError:  # a program without its spans
        return None
    s = tracing.summarize(*((run.dtrace.t0, run.dtrace.t1) if run.dtrace is not None else ()))
    n = s.get("train.step", {}).get("n", 0)
    return 1e-6 * s.get("train.backward", {}).get("ns", 0) / n if n else None
