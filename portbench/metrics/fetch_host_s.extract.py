"""Mean seconds a volume spends in the fetch's host work
(``extract.fetch.unpack``: ``np.unpackbits``, the count, ``np.flatnonzero``,
the uint8 copy; ``extract.fetch.scatter``: the RGB volume's ``np.zeros`` and
assignment) per ``extract.volume`` span."""


def read(run):
    try:
        from nerfjax_torch import tracing
    except ImportError:  # a program without its spans
        return None
    s = tracing.summarize(*((run.dtrace.t0, run.dtrace.t1) if run.dtrace is not None else ()))
    n = s.get("extract.volume", {}).get("n", 0)
    host = sum(s.get(k, {}).get("ns", 0) for k in ("extract.fetch.unpack", "extract.fetch.scatter"))
    return 1e-9 * host / n if n else None
