"""The share of the traced training window in which no operation ran on
the card (the union of the raw device events)."""


def read(run):
    if run.dtrace is None or run.dtrace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.dtrace.busy_s() / run.dtrace.window_s)
