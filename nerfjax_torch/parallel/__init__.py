"""Several cards (counterpart of ``nerfjax/parallel``): one process per card,
``init_distributed`` to join them, the mesh of ranks, each rank's block of
a batch, and the collectives of the training loop and the extraction."""

from nerfjax_torch.parallel.distributed import (
    all_gather,
    all_reduce_sum_,
    broadcast_,
    broadcast_object,
    init_distributed,
    process_batch_slice,
    rank,
    world_size,
)
from nerfjax_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "init_distributed",
    "process_batch_slice",
    "rank",
    "world_size",
    "all_reduce_sum_",
    "all_gather",
    "broadcast_",
    "broadcast_object",
]
