"""The training step and its optimizer plumbing (counterpart of
``qinco_tpu/train/train_step.py``).

One step: a no-grad beam-search encode (on a CUDA tensor through the
beam step's kernels), the per-step decode losses and their gradients by
autograd, the EMA statistics and codeword-usage histograms, then AdamW
(or Adam) on the gradients clipped by value.  ``accum`` micro-batches
make one step: each one's gradients and losses are multiplied by its
valid-row count, summed, and divided by the total count, so the step
equals one step on all their rows.  The parameters are updated in place:
the optimizer holds the very tensors of the :class:`QincoParams`.

Frozen leaves (the data mean and std, and with IVF the step-0 book:
:func:`optimizer_param_labels`) do not require grad and are in no
parameter group, so they get neither an update nor weight decay.

The optimizer state crosses to and from the JAX package in optax's
layout (:func:`optimizer_leaves`, :func:`load_optimizer_leaves`).

Data-parallel (``mesh`` with a process group): each rank feeds its own
rows.  The encode's residual statistics (each MLP step's) and the ``x0``
statistics are taken over the global batch in two passes (sums and
counts, then squared deviations), two all-reduces each.  The step sums
``grads·n``, ``total·n``, ``losses·n`` and the counts (one f32
all-reduce) and the usage increments (one int64 all-reduce) over the data
axis once, before the division and the clip.  So a step makes ``(2·Ms +
2)·accum + 2`` collectives (``Ms`` MLP steps), and every rank applies the
same update to the same parameters, EMA buffers and usage histograms.
Without a group every reduction is the identity.
"""

from __future__ import annotations

import itertools
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..models.params import ModelState, QincoParams, StepParams, param_leaves
from ..models.qinco import encode, train_losses
from ..models.spec import QincoSpec
from ..parallel.mesh import all_reduce_sum

STATS_MOMENTUM = 0.1


class TrainStepOutput(NamedTuple):
    total_loss: torch.Tensor  # () device scalar
    losses: dict  # name -> () device scalar
    codes: torch.Tensor  # (M_ivf, accum·N) int32


def optimizer_param_labels(params: QincoParams, spec: QincoSpec) -> QincoParams:
    """``"train"`` / ``"frozen"`` for each parameter leaf (None where the
    leaf is absent), as the JAX package's ``optimizer_param_labels``
    (``qinco_tpu/train/train_step.py``): the data mean and std are frozen,
    and so is the step-0 book when it is the IVF book."""
    steps = StepParams(*(None if a is None else "train" for a in params.steps))
    return QincoParams(codebook0="frozen" if spec.ivf_in_use else "train", steps=steps,
                       data_mean="frozen", data_std="frozen")


def trainable_leaves(params: QincoParams, spec: QincoSpec) -> list[torch.Tensor]:
    """The leaves labelled ``"train"``, in :func:`param_leaves` order."""
    labels = param_leaves(optimizer_param_labels(params, spec))
    return [a for a, label in zip(param_leaves(params), labels) if label == "train"]


def build_optimizer(cfg, params: QincoParams, spec: QincoSpec) -> torch.optim.Optimizer:
    """``adamw``: decoupled weight decay on every trainable leaf (codebooks
    and biases included), as optax's unmasked ``adamw``.  ``adam``: the
    decay added to the gradient before Adam (optax's
    ``add_decayed_weights`` ahead of ``adam``).  Marks the trainable
    leaves ``requires_grad`` and the frozen ones not.  (On the CPU torch
    updates leaf by leaf, in a fixed order; on a card it batches the
    leaves.)"""
    name = str(cfg.optimizer).lower()
    wd, lr = float(cfg.wd or 0.0), float(cfg.lr)
    leaves = trainable_leaves(params, spec)
    for a in param_leaves(params):
        a.requires_grad_(False)
    for a in leaves:
        a.requires_grad_(True)
    if name == "adamw":
        return torch.optim.AdamW(leaves, lr=lr, weight_decay=wd, eps=1e-8)
    if name == "adam":
        return torch.optim.Adam(leaves, lr=lr, weight_decay=wd, eps=1e-8)
    raise ValueError(f"Unknown optimizer {cfg.optimizer!r}")


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _micro_batch_pass(spec: QincoSpec, params, leaves, mstate: ModelState, x, weights,
                      reduce):
    """Gradients and losses of one micro-batch, each times its (local)
    valid-row count, the EMA update, and the usage increments.  Returns
    ``(grads·n, (total·n, losses·n), n, codes, mstate, (usage0_inc,
    usage_inc))``.  ``reduce`` sums a list of tensors over the
    data-parallel ranks (the identity in one process)."""
    with tracing.span("train.encode"):
        codes, _, stats = encode(params, spec, x, weights=weights, want_stats=True,
                                 reduce=reduce)
    with tracing.span("train.losses"):
        total, aux = train_losses(params, spec, x, codes, weights)
    with tracing.span("train.backward"):
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    with torch.no_grad(), tracing.span("train.stats"):
        nv = weights.sum()
        nv_all, x_sum = reduce([nv.clone(), (x * weights[:, None]).sum(0)])
        # a fully padded micro-batch (the accumulation tail) moves no EMA
        m = STATS_MOMENTUM * (nv_all > 0).float()
        n_valid = torch.clamp(nv_all, min=1.0)
        x_mean = x_sum / n_valid
        (x_sq,) = reduce([((x - x_mean) ** 2 * weights[:, None]).sum(0)])
        x_var = x_sq / torch.clamp(n_valid - 1.0, min=1.0)
        w_int = weights.long()
        Ms = spec.n_mlp_steps
        mstate = mstate._replace(
            xtarget_mean=m * stats.xtarget_mean + (1 - m) * mstate.xtarget_mean,
            xtarget_var=m * stats.xtarget_std + (1 - m) * mstate.xtarget_var,
            x0_mean=m * x_mean + (1 - m) * mstate.x0_mean,
            x0_std=m * torch.sqrt(x_var) + (1 - m) * mstate.x0_std,
        )
        usage = (torch.zeros(mstate.usage0.shape, dtype=torch.int64, device=x.device)
                 .index_add_(0, codes[0].long(), w_int),
                 torch.zeros(mstate.usage.shape, dtype=torch.int64, device=x.device)
                 .scatter_add_(1, codes[1:].long(), w_int.expand(Ms, -1).contiguous()))
        grads = [torch.zeros_like(a) if g is None else g * nv for g, a in zip(grads, leaves)]
        losses = {k: v.detach() * nv for k, v in aux.items() if k != "xhat"}
    return grads, (total.detach() * nv, losses), nv, codes, mstate, usage


def make_train_step(spec: QincoSpec, opt: torch.optim.Optimizer, grad_clip: float | None,
                    accum: int = 1, mesh=None):
    """The train step ``(params, mstate, batch, weights) -> (params, mstate,
    TrainStepOutput)`` on the parameters that ``opt`` holds.

    ``accum == 1``: ``batch (N, D)`` raw-space rows, ``weights (N,)`` the
    padding mask.  ``accum > 1``: stacked micro-batches ``(accum, N, D)``
    and ``(accum, N)``.  Nothing in the step reads a value back to the
    host.  With a ``mesh`` that has a process group, ``batch`` is this
    rank's share of the global batch and the step is the step on the
    global batch (see the module docstring); ``codes`` are this rank's.
    Each call is the span ``train.step`` (:mod:`qinco_torch.tracing`), its
    id ``step`` the call's count, holding the phases' spans."""
    leaves = _opt_params(opt)
    reduce = partial(all_reduce_sum, mesh, axis="data")  # the identity without a group
    steps = itertools.count()

    def train_step(params: QincoParams, mstate: ModelState, batch, weights):
        with tracing.span("train.step", step=next(steps)):
            return _step(params, mstate, batch, weights)

    def _step(params: QincoParams, mstate: ModelState, batch, weights):
        x_all = (batch - params.data_mean.detach()) / params.data_std.detach()
        if accum == 1:
            grads, (total, losses), nv, codes, mstate, usage = _micro_batch_pass(
                spec, params, leaves, mstate, x_all, weights, reduce)
            n_sum = nv
        else:
            if batch.dim() != 3 or batch.shape[0] != accum:
                raise ValueError(f"accum={accum} expects stacked (accum, N, D) batches, "
                                 f"got {tuple(batch.shape)}")
            grads = total = losses = usage = None
            nvs, all_codes = [], []
            for j in range(accum):
                g, (t, ls), nv, codes, mstate, u = _micro_batch_pass(
                    spec, params, leaves, mstate, x_all[j], weights[j], reduce)
                if grads is None:
                    grads, total, losses, usage = g, t, ls, u
                else:
                    grads = [a + b for a, b in zip(grads, g)]
                    total = total + t
                    losses = {k: losses[k] + v for k, v in ls.items()}
                    usage = tuple(a + b for a, b in zip(usage, u))
                nvs.append(nv)
                all_codes.append(codes)
            n_sum = torch.stack(nvs).sum()
            codes = torch.cat(all_codes, dim=1)  # (M_ivf, accum·N)

        with torch.no_grad(), tracing.span("train.clip"):
            keys = sorted(losses)  # one f32 and one int64 all-reduce
            out = reduce([*grads, total, *(losses[k] for k in keys), n_sum, *usage])
            n = len(grads)
            grads, total, n_sum = out[:n], out[n], out[n + 1 + len(keys)]
            losses = dict(zip(keys, out[n + 1:n + 1 + len(keys)]))
            usage = out[-2:]
            n_total = torch.clamp(n_sum, min=1.0)
            mstate = mstate._replace(usage0=(mstate.usage0.long() + usage[0]).int(),
                                     usage=(mstate.usage.long() + usage[1]).int())
            for a, g in zip(leaves, grads):
                g = g / n_total
                a.grad = g.clamp_(-grad_clip, grad_clip) if grad_clip else g
            total = total / n_total
            losses = {k: v / n_total for k, v in losses.items()}
        with tracing.span("train.optimizer"):
            opt.step()
            opt.zero_grad(set_to_none=True)
        return params, mstate, TrainStepOutput(total, losses, codes)

    return train_step


def reset_usage(mstate: ModelState) -> ModelState:
    return mstate._replace(usage0=torch.zeros_like(mstate.usage0),
                           usage=torch.zeros_like(mstate.usage))


def apply_codebook_reset(params: QincoParams, mstate: ModelState, spec: QincoSpec,
                         rand: torch.Tensor, noise: Optional[torch.Tensor],
                         rand0: Optional[torch.Tensor], noise_init: float = 0.1):
    """Re-initialize the codewords unused over the last epoch from given
    draws: ``rand (Ms, K, D)`` uniform, ``noise (Ms, K, D)`` normal (with
    A > 0) and ``rand0 (K0, D)`` uniform (without IVF).  New rows are the
    draws standardized (population std) and scaled by the EMA residual
    statistics; substep rows get the same values plus noise of
    ``noise_init / 4`` times their std (noise scale 1 in QINCo1 mode).
    Updates the leaves in place; returns ``(params, n_reset (M_ivf,))``
    with a leading step-0 entry (0 with IVF)."""
    steps = params.steps
    with torch.no_grad():
        rand = (rand - rand.mean((1, 2), keepdim=True)) / rand.std((1, 2), keepdim=True,
                                                                  correction=0)
        new_books = rand * mstate.xtarget_var[:, None, :] + mstate.xtarget_mean[:, None, :]
        used = (mstate.usage > 0)[:, :, None]  # (Ms, K, 1)
        noise_scale = noise_init if not spec.qinco1_mode else 1.0
        if spec.has_substep():
            sub_new = new_books + noise * new_books.std((1, 2), keepdim=True, correction=0) * (
                noise_scale / 4)
            steps.sub_codebook.copy_(torch.where(used, steps.sub_codebook, sub_new))
        steps.codebook.copy_(torch.where(used, steps.codebook, new_books))
        n_reset = (~used[..., 0]).sum(1)
        if spec.ivf_in_use:
            n0 = torch.zeros((1,), dtype=n_reset.dtype, device=n_reset.device)
        else:
            rand0 = (rand0 - rand0.mean()) / rand0.std(correction=0)
            new0 = rand0 * mstate.x0_std + mstate.x0_mean
            used0 = (mstate.usage0 > 0)[:, None]
            params.codebook0.copy_(torch.where(used0, params.codebook0, new0))
            n0 = (~used0[:, 0]).sum()[None]
    return params, torch.cat([n0, n_reset])


def reset_unused_codebooks(generator: torch.Generator, params: QincoParams,
                           mstate: ModelState, spec: QincoSpec, noise_init: float = 0.1):
    """:func:`apply_codebook_reset` with its draws taken from ``generator``
    (on the parameters' device)."""
    device = params.codebook0.device
    shape = (spec.n_mlp_steps, spec.K, spec.D)
    rand = torch.rand(shape, generator=generator, device=device)
    noise = torch.randn(shape, generator=generator, device=device) if spec.has_substep() else None
    rand0 = None if spec.ivf_in_use else torch.rand((spec.K0, spec.D), generator=generator,
                                                    device=device)
    return apply_codebook_reset(params, mstate, spec, rand, noise, rand0, noise_init)


def _opt_params(opt: torch.optim.Optimizer) -> list[torch.Tensor]:
    return [a for group in opt.param_groups for a in group["params"]]


def _hyperparams(opt: torch.optim.Optimizer, group: dict) -> dict:
    """The hyperparameters that optax injects, by name, from a group."""
    if not isinstance(opt, torch.optim.AdamW):
        return {"learning_rate": group["lr"]}
    b1, b2 = group["betas"]
    return dict(b1=b1, b2=b2, eps=group["eps"], eps_root=0.0, learning_rate=group["lr"],
                weight_decay=group["weight_decay"])


# The JAX package's optimizer state (``build_optimizer`` there) flattens in
# optax's order: multi_transform's "frozen" branch (set_to_zero) has no
# leaves; the "train" branch is inject_hyperparams' count, its
# hyperparameters in sorted name order (a dict's flatten order), then the
# inner state.  adamw's inner state is (ScaleByAdamState(count, mu, nu),
# ...); adam's is (add_decayed_weights or identity, with no leaves, then
# (ScaleByAdamState, ...)).  mu and nu run over the trainable leaves in
# ``param_leaves`` order.
def optimizer_leaves(opt: torch.optim.Optimizer) -> list[np.ndarray]:
    """The optimizer state as the JAX package's checkpoint holds it (its
    ``opt_*`` leaves): the step count (int32), the injected
    hyperparameters by name (float32; ``learning_rate`` alone for
    ``adam``), the step count again, then ``exp_avg`` (optax's mu) and
    ``exp_avg_sq`` (nu) of each trainable leaf."""
    params = _opt_params(opt)
    states = [opt.state.get(a, {}) for a in params]
    count = np.asarray(int(states[0].get("step", 0)) if states else 0, np.int32)
    hyper = _hyperparams(opt, opt.param_groups[0])
    head = [count, *(np.asarray(hyper[k], np.float32) for k in sorted(hyper)), count]
    moment = lambda st, key, a: (st[key] if key in st else torch.zeros_like(a)).detach().cpu()
    return head + [moment(st, key, a).numpy() for key in ("exp_avg", "exp_avg_sq")
                   for st, a in zip(states, params)]


def load_optimizer_leaves(opt: torch.optim.Optimizer, leaves: list[np.ndarray],
                          layout: str = "opt") -> None:
    """Restore an optimizer state into ``opt``.

    ``layout="opt"``: the JAX package's optax leaves, or what
    :func:`optimizer_leaves` wrote.  mu and nu become ``exp_avg`` and
    ``exp_avg_sq`` and Adam's count the step.  optax keeps the injected
    hyperparameters in its state, so a stored value that differs from the
    group's at float32 replaces it.  ``layout="torchopt"``: the per-leaf
    (exp_avg, exp_avg_sq, step) triples that earlier versions of the port
    wrote.  Raises ``ValueError`` when the leaf count or a moment's shape
    does not fit the optimizer."""
    params = _opt_params(opt)
    if layout == "torchopt":
        if len(leaves) != 3 * len(params):
            raise ValueError(f"{len(leaves)} optimizer leaves for {len(params)} trainable leaves")
        moments = [leaves[3 * i:3 * i + 3] for i in range(len(params))]
    elif layout == "opt":
        names, n = sorted(_hyperparams(opt, opt.param_groups[0])), len(params)
        h = len(names) + 2
        if len(leaves) != h + 2 * n:
            raise ValueError(
                f"{len(leaves)} optimizer leaves: {type(opt).__name__} over {n} trainable "
                f"leaves has {h + 2 * n} in optax's layout")
        stored = dict(zip(names, (float(v) for v in leaves[1:h - 1])))
        if stored.get("eps_root", 0.0) != 0.0:
            raise ValueError(f"eps_root={stored['eps_root']}: torch's AdamW has none")
        for group in opt.param_groups:
            now = _hyperparams(opt, group)
            new = {k: v if np.float32(v) == np.float32(stored[k]) else stored[k]
                   for k, v in now.items()}
            group["lr"] = new["learning_rate"]
            if "b1" in new:
                group.update(betas=(new["b1"], new["b2"]), eps=new["eps"],
                             weight_decay=new["weight_decay"])
        step = leaves[h - 1]
        moments = [(m, v, step) for m, v in zip(leaves[h:h + n], leaves[h + n:])]
    else:
        raise ValueError(f"unknown optimizer layout {layout!r}")
    for a, (exp_avg, exp_avg_sq, step) in zip(params, moments):
        if np.shape(exp_avg) != tuple(a.shape) or np.shape(exp_avg_sq) != tuple(a.shape):
            raise ValueError(f"optimizer moments of shape {np.shape(exp_avg)} and "
                             f"{np.shape(exp_avg_sq)} for a leaf of shape {tuple(a.shape)}")
        opt.state[a] = {
            "step": torch.tensor(float(step), dtype=torch.float32),
            "exp_avg": torch.as_tensor(exp_avg, device=a.device).clone(),
            "exp_avg_sq": torch.as_tensor(exp_avg_sq, device=a.device).clone(),
        }
