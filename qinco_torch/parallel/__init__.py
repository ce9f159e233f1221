"""Several processes, one card each (counterpart of ``qinco_tpu/parallel/``).

The mapping onto the JAX package:

- One torch rank drives one card (``cuda:<LOCAL_RANK>``, NCCL), or one
  CPU process (gloo, ``cpu=true``).  One JAX *process*, with its local
  chips, corresponds to one torch **model group**.
- The mesh is ``(data, model)``, with ``data = world // model`` when
  ``mesh.data = -1``.  Rank ``r`` has data index ``r // model`` and model
  index ``r % model``.  It is built with
  ``torch.distributed.device_mesh.init_device_mesh(..., mesh_dim_names=
  ("data", "model"))``: ``"cuda"`` under NCCL, ``"cpu"`` under gloo.
- Work that JAX splits over processes (loader shards, DB slices, part
  files) splits over data groups.
- Work that JAX splits over the ``model`` axis (the IVF book) splits over
  the ranks of one model group (:mod:`.sharded_ops`).
- In training the model axis replicates, as in JAX: every rank of a model
  group feeds the same rows, and gradients are summed over the data axis.

Launch (the counterpart of ``QINCO_* python run_qinco.py``)::

    python -m torch.distributed.run --nproc_per_node=N -m qinco_torch task=train ...

or, on each host, ``QINCO_COORDINATOR=host0:port QINCO_NUM_PROCS=N
QINCO_PROC_ID=i python -m qinco_torch ...``.  Without these variables no
process group exists, every mesh is the trivial ``1 x 1`` one and every
collective helper returns its input.
"""

from .distributed import maybe_init_distributed, shutdown
from .mesh import Mesh, all_gather_cat, all_reduce_sum, barrier, make_mesh, replicate

__all__ = ["Mesh", "make_mesh", "replicate", "all_reduce_sum", "all_gather_cat", "barrier",
           "maybe_init_distributed", "shutdown"]
