"""Multi-process start-up and the collectives of the port (counterpart of
``nerfjax/parallel/distributed.py``).

nerfjax runs one process per host over a device mesh; the port runs one
process per card, PyTorch's idiom, joined by ``torch.distributed``:

  * ``init_distributed()`` joins the world from the same environment as
    nerfjax's (``NERFJAX_COORDINATOR`` / ``NERFJAX_NUM_PROCESSES`` /
    ``NERFJAX_PROCESS_ID``, or ``NERFJAX_DISTRIBUTED=1`` with torchrun's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``); with
    none of them set it is a no-op and the process is a world of one.
  * ``process_batch_slice`` gives rank r rows [r*B/W, (r+1)*B/W) of a
    global batch, as nerfjax gives process p its block.
  * ``all_reduce_sum_``, ``all_gather`` and ``broadcast_`` are the
    collectives the training loop and the extraction use. Under gloo a
    CUDA tensor goes through a pinned host buffer, so two ranks can share
    one card (NCCL refuses that).

nerfjax's ``put_process_local`` has no counterpart: it assembles a global
jax array from each process's block, and in the port no global array
exists. Each rank holds only its own block, which ``data.prefetch_to_device``
copies to its card as it is.
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.distributed as dist


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
    backend: str | None = None,
) -> tuple[int, int]:
    """Join the world; a no-op for a single process. Returns (rank, world).

    Each field resolves from its argument, then ``NERFJAX_COORDINATOR``
    (``host:port`` of rank 0) / ``NERFJAX_NUM_PROCESSES`` /
    ``NERFJAX_PROCESS_ID``. Without a coordinator and more than one process,
    ``NERFJAX_DISTRIBUTED=1`` joins from ``env://`` (torchrun's ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). With neither it
    returns (0, 1) and starts nothing. A second call returns the world it
    joined.

    ``backend``: "nccl" when CUDA is available, else "gloo"; the CPU tests
    and two ranks on one card pass "gloo". On CUDA the process's card is
    ``local_device_ids[0]``, else ``LOCAL_RANK``, else the rank modulo the
    cards present. A rendezvous that fails raises.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = coordinator_address or os.environ.get("NERFJAX_COORDINATOR")
    nproc = num_processes
    if nproc is None:
        nproc = int(os.environ.get("NERFJAX_NUM_PROCESSES", "0") or 0)
    pid = process_id
    if pid is None:
        pid_env = os.environ.get("NERFJAX_PROCESS_ID")
        pid = int(pid_env) if pid_env is not None else None
    if coord and nproc and nproc > 1:
        if pid is None:
            raise ValueError("NERFJAX_COORDINATOR and NERFJAX_NUM_PROCESSES need NERFJAX_PROCESS_ID (or process_id=)")
        init_method, rank, world = f"tcp://{coord}", pid, nproc
    elif os.environ.get("NERFJAX_DISTRIBUTED"):
        init_method, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return 0, 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        if local_device_ids:
            local = int(local_device_ids[0])
        elif os.environ.get("LOCAL_RANK") is not None:
            local = int(os.environ["LOCAL_RANK"])
        else:
            local = rank % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(backend=backend, init_method=init_method, rank=rank, world_size=world)
    return dist.get_rank(), dist.get_world_size()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_batch_slice(batch: Any, global_batch_size: int | None = None) -> Any:
    """This rank's contiguous block of a global batch dict (numpy arrays or
    tensors): rows [r*B/W, (r+1)*B/W). The batch itself at a world of one.
    Every leading dim must be divisible by the world size."""
    world = world_size()
    if world == 1:
        return batch
    r = rank()

    def _slice(x):
        n = x.shape[0]
        if n % world:
            raise ValueError(f"batch dim {n} not divisible by process_count {world}")
        block = n // world
        return x[r * block : (r + 1) * block]

    return {k: _slice(v) for k, v in batch.items()}


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` (the world when None), in place;
    every rank holds the same sum."""
    if _staged(t, group):
        buf = _host(t)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        t.copy_(buf)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each), in rank order of
    ``group``, on ``t``'s device."""
    n = dist.get_world_size(group)
    src = _host(t) if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank, in place."""
    if _staged(t, group):
        buf = _host(t)
        dist.broadcast(buf, src=src, group=group)
        t.copy_(buf)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """A picklable object of rank ``src`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
