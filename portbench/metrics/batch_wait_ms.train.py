"""Mean host ms a training step waits in ``next()`` of the prefetch
iterator (the benchmark's span around the batch feed)."""


def read(run):
    n = run.spans.count("batch_wait")
    return 1e3 * run.spans.total_s("batch_wait") / n if n else None
