"""The process mesh of the port (counterpart of ``nerfjax/parallel/mesh.py``).

nerfjax lays a ``jax.sharding.Mesh`` over its devices; the port's world is
one process per card, so its mesh is a layout of ranks. Rank r sits at
(r // tp, r % tp) of a (dp, tp) mesh, process-major as nerfjax orders its
devices. Every rank takes its own block of the ray batch (data parallelism
over the whole world); the hash table, with ``shard_hash_table``, is split
along T over the ranks of one mesh row (the ``model`` axis): on the default
1-D mesh that row is the whole world, on a (dp, tp) mesh each of the dp
rows holds one whole table split over its tp ranks.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from nerfjax_torch.parallel.distributed import rank, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """(dp, tp) ranks; ``axis_names`` ("data",) for the 1-D mesh, else
    ("data", "model"). ``table_group`` is the process group of this rank's
    mesh row, the ranks one table is split over (None: the whole world,
    or no group at all at a world of one)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int
    table_group: object = None

    @property
    def world(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def table_size(self) -> int:
        """Ranks one table is split over (the model axis' size)."""
        return self.shape[-1]

    @property
    def table_index(self) -> int:
        """This rank's place on the model axis."""
        return self.rank % self.table_size


def make_mesh(shape: tuple[int, int] | None = None) -> Mesh:
    """The mesh over the world (``init_distributed`` first, where there is one).

    Default: the 1-D ``(data,)`` mesh over every rank. ``shape=(dp, tp)``:
    the 2-D ``(data, model)`` mesh; dp * tp must equal the world size. Every
    rank must call it, with the same shape: the row groups are made here."""
    world, r = world_size(), rank()
    if shape is None:
        return Mesh((world,), (DATA_AXIS,), r)
    dp, tp = int(shape[0]), int(shape[1])
    if dp * tp != world:
        raise ValueError(f"mesh shape {dp}x{tp} != {world} devices")
    group = None
    if 1 < tp < world:
        for row in range(dp):  # every rank makes every row's group, in the same order
            g = dist.new_group(list(range(row * tp, (row + 1) * tp)))
            if row == r // tp:
                group = g
    return Mesh((dp, tp), (DATA_AXIS, MODEL_AXIS), r, group)
