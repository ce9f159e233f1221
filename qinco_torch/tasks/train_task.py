"""The training task and its ``eval_valset`` variant (counterpart of
``qinco_tpu/tasks/train_task.py``).

Per epoch: the usage histograms reset, one optimizer step per group of
``grad_accumulate`` loader batches with the cosine learning rate read at
the fractional epoch, the validation MSE, the best checkpoint, then the
dead-codeword reset.  Losses are summed on the device and read on the host
only every ``log_every`` batches, so the card does not wait on the host
between steps.

Data-parallel over a process group: each data group reads its shard of
the rows (``batch`` rows a step each, a global batch of ``batch x
data_size``); the parameters and model state are broadcast from rank 0
after loading; the step and the validation MSE sum over the data axis, so
every rank holds the same parameters and takes the same decisions (the
plateau schedule, the best checkpoint, the early stop).  Only rank 0
prints and saves."""

from __future__ import annotations

import numpy as np
import torch

from ..data.datasets import Batch, load_vec_trainset
from ..logsys import MetricLogger
from ..metrics import corrected_mse
from ..models.params import param_leaves
from ..models.scheduler import ReduceLROnPlateau, build_schedule
from ..ops.rq import train_rq
from ..parallel.mesh import replicate
from ..train.loop import compute_mse
from ..train.train_step import (
    build_optimizer,
    load_optimizer_leaves,
    make_train_step,
    optimizer_leaves,
    reset_unused_codebooks,
    reset_usage,
    set_learning_rate,
)
from ..utils import Timer, host_to_device, sync
from .base import BaseTask


def _grouped_batches(it, accum: int):
    """Group loader micro-batches ``accum`` at a time, padding the final
    group with zero-valid batches so every step has one shape."""
    buf = []
    for b in it:
        buf.append(b)
        if len(buf) == accum:
            yield buf
            buf = []
    if buf:
        zero = np.zeros_like(buf[0].x)
        while len(buf) < accum:
            buf.append(Batch(zero, 0))
        yield buf


class TrainTask(BaseTask):
    DISTRIBUTED = True

    def setup(self):
        super().setup()
        cfg = self.cfg
        if cfg.task == "train":
            if not cfg.output or not str(cfg.output).endswith(".npz"):
                raise ValueError("Specify 'output', a .npz file, to store model weights")
            if cfg.model is None:
                for arg in ["L", "dh", "M", "K", "A", "B"]:
                    if cfg.get(arg) is None:
                        raise ValueError(f"Specify '{arg}' or use a model_args preset")

    def load_data(self):
        cfg = self.cfg
        self.print(f"Loading training data from {cfg.trainset}")
        (self.train_vecs, self.val_vecs), (self.train_loader, self.val_loader) = (
            load_vec_trainset(cfg, shard=(self.mesh.data_rank, self.mesh.data_size)))
        self.print(f"Training set: {self.train_vecs.shape}")
        self.print(f"Validation set: {self.val_vecs.shape}")
        self.data_dim = self.train_vecs.shape[-1]

    def compute_data_stats(self):
        """The data mean (D,) and one scalar std over the first 100k rows;
        in QINCo1 mode the map of the trainset's [min, max] onto [-1, 1]."""
        cfg = self.cfg
        if cfg.task != "train":
            return None, None
        if cfg.qinco1_mode:
            d_min, d_max = np.inf, -np.inf
            for i in range(0, len(self.train_vecs), 1_000_000):
                blk = np.asarray(self.train_vecs[i:i + 1_000_000])
                d_min = min(d_min, float(blk.min()))
                d_max = max(d_max, float(blk.max()))
            mean = np.ones((self.data_dim,), np.float32) * d_min + 1
            std = (d_max - d_min) / 2
            self.print(f"QINCo1 mode: rescale interval [{d_min:g};{d_max:g}] to [-1;1]")
            return mean, std
        stats = np.asarray(self.train_vecs[:100_000], np.float32)
        mean = stats.mean(0)
        std = float(stats.std())
        self.print(f"Data mean {mean.mean():.3g}, std {std:.3g}")
        return mean, std

    def train_rq_init(self):
        """RQ bootstrap of the codebooks on the task's device."""
        cfg = self.cfg
        self.print("====================== residual quantizer training")
        x = np.asarray(self.train_vecs[:1_000_000], np.float32)
        ivf_raw = self.ivf_centroids if self.spec.ivf_in_use else None
        with Timer() as t:
            centroids, xq = train_rq(x, self.spec.M_ivf, self.spec.K, iters=10, seed=cfg.seed,
                                     ivf_centroids=ivf_raw, device=self.device)
        self.rq_mse = corrected_mse(xq, x, cfg.mse_scale)
        self.print(f"RQ init train MSE={self.rq_mse:g} ({t.s()})")
        return centroids

    def _reset_codebooks(self, params, mstate, epoch: int):
        """The dead-codeword reset at the end of ``epoch``, with draws from a
        generator seeded ``seed + 1234 + epoch``: they depend on the seed and
        the epoch alone, so a resumed run draws what an uninterrupted one
        draws.  Returns ``(params, n_reset)`` with n_reset on the host."""
        g = torch.Generator(device=self.device).manual_seed(int(self.cfg.seed) + 1234 + epoch)
        params, n_reset = reset_unused_codebooks(g, params, mstate, self.spec,
                                                 noise_init=self.cfg.codebook_noise_init)
        return params, n_reset.cpu().numpy()

    def run(self):
        cfg, spec, device, mesh = self.cfg, self.spec, self.device, self.mesh
        eval_only = cfg.task != "train"
        # rank 0's parameters and model state (fresh, or restored) everywhere
        replicate(mesh, param_leaves(self.params) + list(self.mstate))

        schedule = build_schedule(cfg)
        opt = build_optimizer(cfg, self.params, spec)
        accum = max(1, int(cfg.get("grad_accumulate", 1) or 1))
        train_step = make_train_step(spec, opt, cfg.grad_clip, accum=accum, mesh=mesh)

        start_epoch = 0
        melog = MetricLogger(cfg, is_main=self.is_main, save_fn=None)
        if self.restored is not None and self.ckpt_meta is not None and not eval_only:
            meta = self.restored["meta"]
            if self.restored["opt_state"] is not None:
                load_optimizer_leaves(opt, self.restored["opt_state"])
            else:
                self.print("The checkpoint holds none of the port's optimizer leaves; "
                           "the optimizer starts afresh")
            if meta.get("epoch") is not None:
                start_epoch = int(meta["epoch"])
            if meta.get("scheduler"):
                schedule.load_state_dict(meta["scheduler"])
            if meta.get("logger"):
                melog.load_state_dict(meta["logger"])

        params, mstate = self.params, self.mstate
        if start_epoch > 0 and self.restored["mstate"] is not None:
            # The checkpoint was written before its epoch's dead-codeword
            # reset; the reset's draws and the saved usage histograms give
            # that reset again, so the run goes on as an uninterrupted one.
            params, _ = self._reset_codebooks(params, mstate, start_epoch - 1)
        epoch = start_epoch
        melog.cur_epoch = epoch - 1

        def save_best(reason):
            self.params, self.mstate = params, mstate
            self.save(epoch=epoch + 1, opt_state=optimizer_leaves(opt),
                      scheduler_state=schedule.state_dict(), logger_state=melog.state_dict())

        melog.save_fn = save_best

        mse_val = compute_mse(params, spec, self.val_loader, melog, mse_scale=cfg.mse_scale,
                              mesh=mesh)
        self.print(f"Validation metrics: [[MSE={mse_val:g}]]")
        if eval_only:
            melog.close()
            return mse_val

        log_every = max(1, int(cfg.get("log_every", 10) or 1))
        while not melog.should_stop():
            melog.cur_epoch = epoch
            if isinstance(schedule, ReduceLROnPlateau):
                schedule.step(mse_val)
            # one step = `accum` loader batches
            n_batches = max(1, -(-len(self.train_loader) // accum))
            lr = schedule.lr(epoch)
            melog.start_epoch(epoch, n_batches, lr)
            mstate = reset_usage(mstate)

            sum_total, sum_each, n_seen = None, {}, 0
            for i_batch, group in enumerate(
                    _grouped_batches(self.train_loader.epoch(epoch), accum)):
                lr = schedule.lr(epoch + (i_batch + 1) / n_batches)
                set_learning_rate(opt, lr)
                x_np = np.stack([g.x for g in group])
                w = np.zeros(x_np.shape[:2], np.float32)
                for j, g in enumerate(group):
                    w[j, : g.n_valid] = 1.0
                if accum == 1:
                    x_np, w = x_np[0], w[0]
                params, mstate, out = train_step(params, mstate, host_to_device(x_np, device),
                                                 host_to_device(w, device))
                nv = int(w.sum()) * mesh.data_size  # equal shards: the global count
                n_seen += nv
                sum_total = out.total_loss * nv if sum_total is None else (
                    sum_total + out.total_loss * nv)
                for k, v in out.losses.items():
                    sum_each[k] = v * nv if k not in sum_each else sum_each[k] + v * nv
                if i_batch % log_every == 0 or i_batch == n_batches - 1:
                    melog.step_batch(i_batch, nv, out.total_loss, out.losses, lr)
                else:
                    melog.cur_step += 1
            sync(device)
            melog.end_train_phase()

            mse_val = compute_mse(params, spec, self.val_loader, melog,
                                  mse_scale=cfg.mse_scale, mesh=mesh)
            usage_rows = [mstate.usage0.cpu().numpy(), *mstate.usage.cpu().numpy()]
            melog.end_epoch(
                mse_val, usage_rows=usage_rows,
                mean_loss=float(sum_total) / max(n_seen, 1),
                mean_all={k: float(v) / max(n_seen, 1) for k, v in sum_each.items()})

            params, n_reset = self._reset_codebooks(params, mstate, epoch)
            if n_reset.sum():
                self.print(f"Reset {int(n_reset.sum())} codewords at end of epoch {epoch} "
                           f"(per step: {n_reset.tolist()})")
            epoch += 1

        self.print(f"[T_total={melog.timers.total} | T_train={melog.timers.train}] "
                   f"Training done: {melog.cur_step} steps in {melog.timers.train.s()} of "
                   "train phases")
        self.params, self.mstate = params, mstate
        melog.close()
        return melog.best_mse
