"""Mean seconds a volume spends bringing the volumes to the host (the
program's own ``metadata["transfer_seconds"]``)."""


def read(run):
    md = run.extra.get("metadata")
    return sum(m["transfer_seconds"] for m in md) / len(md) if md else None
