"""Process-group start-up (counterpart of ``qinco_tpu/parallel/distributed.py``).

:func:`maybe_init_distributed` starts one ``torch.distributed`` group
from the environment, before any CUDA tensor exists:

- ``torch.distributed.run`` (torchrun) sets ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; the group joins
  through ``env://``.
- The JAX package's ``QINCO_COORDINATOR`` (``host:port``, or a whole
  ``tcp://`` or ``file://`` init URL), ``QINCO_NUM_PROCS`` and
  ``QINCO_PROC_ID`` join through ``tcp://<coordinator>``.

On the card the backend is NCCL, after ``torch.cuda.set_device(local
rank)``; gloo only when the caller asks for the CPU.  A group on the card
without CUDA, or a failed NCCL start, raises: it never turns into gloo.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

# How long a collective (and the rendezvous) waits for the other ranks
# before it raises instead of hanging.
TIMEOUT = timedelta(minutes=10)


def _rendezvous() -> tuple[str, int, int, int | None] | None:
    """``(init_method, world, rank, local_rank or None)`` from the
    environment, or None when it names no group."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(f"RANK and WORLD_SIZE are set but {', '.join(missing)} is not")
        local = env.get("LOCAL_RANK")
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"]), (
            None if local is None else int(local))
    coord = env.get("QINCO_COORDINATOR")
    if coord:
        if "QINCO_NUM_PROCS" not in env or "QINCO_PROC_ID" not in env:
            raise RuntimeError("QINCO_COORDINATOR needs QINCO_NUM_PROCS and QINCO_PROC_ID")
        url = coord if "://" in coord else f"tcp://{coord}"
        return url, int(env["QINCO_NUM_PROCS"]), int(env["QINCO_PROC_ID"]), None
    return None


def maybe_init_distributed(cpu: bool) -> bool:
    """Start the process group that the environment names.  Returns True
    when this call started one; False when the environment names none (no
    group is created) or a group already exists."""
    if dist.is_initialized():
        return False
    found = _rendezvous()
    if found is None:
        return False
    init_method, world, rank, local_rank = found
    if cpu:
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a process group on the card needs CUDA and none is available; "
                "pass cpu=true for a group of CPU processes")
        if local_rank is None:
            local_rank = rank % torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    return True


def shutdown() -> None:
    """Tear the process group down, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
