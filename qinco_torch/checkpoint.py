"""Checkpoint I/O in the JAX package's npz format
(counterpart of ``qinco_tpu/checkpoint.py:24-128``).

One ``.npz`` holds the parameter leaves as ``params_0000``, ``params_0001``,
... in JAX tree order with ``None`` leaves dropped, the :class:`ModelState`
leaves as ``mstate_*`` in its field order (four float32 arrays, then the
int32 usage histograms), optional optimizer leaves, and a ``_meta`` JSON
record (uint8 bytes) with the leaf counts, the epoch, the scheduler and
logger states and the hyper-parameters.  Parameters and model state cross
between the packages both ways.

The port writes its optimizer state as ``torchopt_*`` leaves: for each
trainable leaf in :func:`~qinco_torch.models.params.param_leaves` order,
``exp_avg``, ``exp_avg_sq`` and ``step``
(``train.train_step.optimizer_leaves``).  The JAX package's optimizer
leaves are ``opt_*``, in optax's own state tree.  Each package resumes
only its own optimizer leaves and starts a fresh optimizer from the
other's checkpoint.

:func:`load_torch_checkpoint` and :func:`params_from_torch_state` import a
reference-trained ``.pt`` checkpoint (counterpart of
``qinco_tpu/checkpoint.py:136-249``), the ``convert`` task's path.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .models.params import (
    ModelState,
    QincoParams,
    StepParams,
    init_model_state,
    param_leaves,
    params_from_numpy,
)
from .models.spec import QincoSpec
from .utils import resolve_device

SAVED_PARAMETERS = ["K", "M", "de", "dh", "L", "A", "B", "ivf_in_use", "ivf_K", "qinco1_mode"]


def save_checkpoint(
    path: str | Path,
    *,
    params: QincoParams,
    model_state: ModelState | None = None,
    opt_state: list[np.ndarray] | None = None,
    epoch: int | None = None,
    scheduler_state: dict | None = None,
    logger_state: dict | None = None,
    hyperparams: dict | None = None,
    data_dim: int | None = None,
) -> None:
    """Write a checkpoint; ``opt_state`` is the port's optimizer layout."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {
        "epoch": epoch,
        "scheduler": scheduler_state,
        "logger": logger_state,
        "parameters": hyperparams or {},
        "data_dim": data_dim,
        "counts": {},
    }
    host = lambda leaves: [a.detach().cpu().numpy() for a in leaves]
    trees = (
        ("params", host(param_leaves(params))),
        ("mstate", None if model_state is None else host(model_state)),
        ("torchopt", opt_state),
    )
    for name, leaves in trees:
        if leaves is None:
            meta["counts"][name] = -1
            continue
        meta["counts"][name] = len(leaves)
        for i, leaf in enumerate(leaves):
            arrays[f"{name}_{i:04d}"] = np.asarray(leaf)
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.rename(path)


def load_checkpoint_meta(path: str | Path) -> dict:
    with np.load(path) as data:
        return json.loads(bytes(data["_meta"]).decode("utf-8"))


def load_checkpoint(path: str | Path, spec: QincoSpec, *, device=None) -> dict:
    """Restore a checkpoint: ``{"meta", "params", "mstate", "opt_state"}``.
    ``params`` is a :class:`QincoParams` and ``mstate`` a
    :class:`ModelState` (or None) on ``device`` (default ``cuda``);
    ``opt_state`` is the list of the port's numpy optimizer leaves, or None
    when the checkpoint holds none (as one the JAX package wrote)."""
    device = resolve_device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["_meta"]).decode("utf-8"))
        counts = meta["counts"]

        def leaves(name):
            n = counts.get(name, -1)
            return None if n < 0 else [data[f"{name}_{i:04d}"] for i in range(n)]

        params = leaves("params")
        if params is None:
            raise ValueError(f"{path} holds no parameters")
        mstate = leaves("mstate")
        if mstate is not None:
            if len(mstate) != len(ModelState._fields):
                raise ValueError(f"{path}: {len(mstate)} model-state leaves, expected "
                                 f"{len(ModelState._fields)}")
            dtypes = [torch.float32] * 4 + [torch.int32] * 2
            mstate = ModelState(*(torch.as_tensor(np.asarray(a), dtype=dt, device=device)
                                  for a, dt in zip(mstate, dtypes)))
        return {
            "meta": meta,
            "params": params_from_numpy(spec, params, device=device),
            "mstate": mstate,
            "opt_state": leaves("torchopt"),
        }


# ---------------------------------------------------------------------------
# Reference (.pt) checkpoint import
# ---------------------------------------------------------------------------


def load_torch_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """Read a reference torch checkpoint -> (state arrays by key, metadata
    ``{epoch, parameters, data_dim}``).  Tensors only: the file is read with
    ``weights_only=True``."""
    state = torch.load(str(path), map_location="cpu", weights_only=True)
    model_sd = state["model"] if "model" in state else state
    model_sd = {k.replace("module.", ""): v.numpy() for k, v in model_sd.items()}
    meta = {"epoch": state.get("epoch"), "parameters": state.get("parameters", {}),
            "data_dim": state.get("data_dim")}
    return model_sd, meta


def params_from_torch_state(model_sd: dict, spec: QincoSpec, *,
                            device=None) -> tuple[QincoParams, ModelState]:
    """Map a reference state dict onto ``(QincoParams, ModelState)`` on
    ``device`` (default ``cuda``).

    Reference module paths (``qinco/model/qinco_base.py``):
    ``steps.{m}.codebook.weight``, ``steps.{m}.substep.codebook.weight``,
    ``steps.{m}.concat.mlp.{weight,bias}``,
    ``steps.{m}.residual_blocks.{l}.{up_proj,down_proj}.weight``,
    ``steps.{m}.{in,out}_proj.weight``, ``steps.0.ivf_centroids.weight``
    (IVF step 0), ``steps.{m}.{xtarget_mean,xtarget_var}``, ``data_mean``,
    ``data_std``.  A torch Linear weight is (out, in); the port's layout is
    (in, out), so those are transposed.  The reference has no low-rank
    concat factor (``concat_w2`` is None); ``sub_codebook`` is there only
    when the spec has a substep, the projections only when De != D."""
    device = resolve_device(device)
    steps_m = range(1, 1 + spec.n_mlp_steps)  # step 0 is codebook-only or IVF

    def get(key):
        if key not in model_sd:
            raise KeyError(f"missing key {key} in torch checkpoint")
        return np.asarray(model_sd[key], np.float32)

    def stack(fmt, transpose=False, optional=False):
        keys = [fmt.format(m=m) for m in steps_m]
        if optional and any(k not in model_sd for k in keys):
            return None
        return np.stack([get(k).T if transpose else get(k) for k in keys])

    def blocks(name):
        return np.stack([np.stack([get(f"steps.{m}.residual_blocks.{l}.{name}.weight").T
                                   for l in range(spec.L)]) for m in steps_m])

    proj = spec.De != spec.D
    steps = StepParams(
        codebook=stack("steps.{m}.codebook.weight"),
        sub_codebook=(stack("steps.{m}.substep.codebook.weight", optional=True)
                      if spec.has_substep() else None),
        concat_w=stack("steps.{m}.concat.mlp.weight", transpose=True),
        concat_w2=None,
        concat_b=stack("steps.{m}.concat.mlp.bias"),
        ffn_up=blocks("up_proj"),
        ffn_down=blocks("down_proj"),
        in_proj=stack("steps.{m}.in_proj.weight", transpose=True) if proj else None,
        out_proj=stack("steps.{m}.out_proj.weight", transpose=True) if proj else None,
    )
    t = lambda a: None if a is None else torch.from_numpy(np.array(a, np.float32)).to(device)
    codebook0 = get("steps.0.ivf_centroids.weight" if spec.ivf_in_use
                    else "steps.0.codebook.weight")
    params = QincoParams(t(codebook0), StepParams(*(t(a) for a in steps)),
                         t(get("data_mean")), t(get("data_std").reshape(())))

    mstate = init_model_state(spec, device=device)
    if f"steps.{steps_m.start}.xtarget_mean" in model_sd:
        mstate = mstate._replace(xtarget_mean=t(stack("steps.{m}.xtarget_mean")),
                                 xtarget_var=t(stack("steps.{m}.xtarget_var")))
    return params, mstate
