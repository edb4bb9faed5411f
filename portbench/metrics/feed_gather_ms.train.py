"""Mean host ms the batch feed spends gathering one batch's rows
(``RayDataset.epoch_batches``' five fancy-index gathers: the program's
``feed.gather`` span), over the traced window."""


def read(run):
    try:
        from nerfjax_torch import tracing
    except ImportError:  # a program without its spans
        return None
    s = tracing.summarize(*((run.dtrace.t0, run.dtrace.t1) if run.dtrace is not None else ()))
    n = s.get("feed.gather", {}).get("n", 0)
    return 1e-6 * s["feed.gather"]["ns"] / n if n else None
