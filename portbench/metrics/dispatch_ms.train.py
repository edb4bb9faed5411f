"""Mean host ms of the ``train_step`` call (its enqueue; the benchmark's
span, which also holds the step's uniforms)."""


def read(run):
    n = run.spans.count("dispatch")
    return 1e3 * run.spans.total_s("dispatch") / n if n else None
