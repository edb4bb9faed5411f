"""Mean seconds a volume spends querying the field (the program's own
``metadata["query_seconds"]``: the coarse pass, the fine pass and Otsu,
each lap ending in a synchronize)."""


def read(run):
    md = run.extra.get("metadata")
    return sum(m["query_seconds"] for m in md) / len(md) if md else None
