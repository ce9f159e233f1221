"""The ``(data, model)`` mesh over the ranks of a process group, and the
collectives the port makes on it (counterpart of
``qinco_tpu/parallel/mesh.py``).

Global-batch contract: every rank feeds ``cfg.batch`` rows a step, so the
global batch is ``batch x data_size``; data group ``g`` reads the
contiguous shard ``g`` of the rows (``data/datasets.py`` ``shard=``).

The helpers use only ``all_reduce``, ``broadcast``, ``all_gather`` (list
form) and ``barrier``, which every PyTorch of the 2.x line has.  Without a
process group each helper returns its input.  ``COLLECTIVES`` counts the
collectives made and the bytes they carried (each rank's buffer once).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

COLLECTIVES = {"calls": 0, "bytes": 0}


@dataclass(frozen=True)
class Mesh:
    device_mesh: Optional[object]  # torch DeviceMesh; None without a process group
    data_rank: int = 0
    data_size: int = 1
    model_rank: int = 0
    model_size: int = 1
    rank: int = 0
    world: int = 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def grouped(self) -> bool:
        return self.device_mesh is not None

    def group(self, axis: str):
        """The process group of ``axis``: "data", the ranks that share this
        rank's model index; "model", its model group."""
        return self.device_mesh.get_group(axis)


TRIVIAL = Mesh(None)


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The ``data x model`` mesh over the process group's ranks;
    ``data=-1`` takes ``world // model``.  Raises where ``data x model``
    is not the world size.  Without a group the world is one rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        if world % model:
            raise ValueError(f"{world} ranks are not divisible by mesh.model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    if not dist.is_initialized():
        return TRIVIAL
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
    rank = dist.get_rank()
    return Mesh(dm, data_rank=rank // model, data_size=data, model_rank=rank % model,
                model_size=model, rank=rank, world=world)


def _count(t: torch.Tensor) -> None:
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()


def _by_dtype(tensors: Sequence[torch.Tensor]) -> dict:
    """Positions of the tensors grouped by dtype, in order of first
    appearance (the same on every rank that passes the same list)."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> list[torch.Tensor]:
    """``op(buffer)`` on one flat buffer per dtype; the results are copied
    back into ``tensors``, which are returned."""
    tensors = list(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _count(flat)
        op(flat)
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
    return tensors


def all_reduce_sum(mesh: Mesh | None, tensors: Sequence[torch.Tensor],
                   axis: str = "data") -> list[torch.Tensor]:
    """Sum ``tensors`` over the ranks of ``axis``, in place: one
    all-reduce per dtype.  The identity without a group."""
    if mesh is None or not mesh.grouped:
        return list(tensors)
    group = mesh.group(axis)
    return _flat_collective(tensors, lambda f: dist.all_reduce(f, op=dist.ReduceOp.SUM,
                                                               group=group))


def replicate(mesh: Mesh | None, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Broadcast ``tensors`` (parameters, model state) from global rank 0
    to every rank, in place: one broadcast per dtype."""
    if mesh is None or not mesh.grouped:
        return list(tensors)
    with torch.no_grad():
        return _flat_collective(tensors, lambda f: dist.broadcast(f, src=0))


def all_gather_cat(mesh: Mesh | None, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The model group's ``t`` (one shape on every rank) concatenated
    along ``dim``, in the order of their model index."""
    if mesh is None or not mesh.grouped:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
    _count(t)
    dist.all_gather(parts, t, group=mesh.group("model"))
    return torch.cat(parts, dim=dim)


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of the group (under NCCL, on this rank's card)."""
    if mesh is None or not mesh.grouped:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
