"""Training and evaluation logging: smoothed losses, best-MSE tracking,
checkpoint on best, early stopping, scalar export (counterpart of
``qinco_tpu/logsys.py``).

Scalars go to a JSONL event file under ``cfg.tensorboard``, and to
TensorBoard as well where ``torch.utils.tensorboard`` imports."""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path

import numpy as np

from .metrics import ENTROPY_MAX_CODES, MSEMetric, codebook_entropy
from .utils import TimersManager


class SmoothedValue:
    """Windowed median and global average of a scalar."""

    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(list(self.deque))) if self.deque else float("nan")

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self) -> str:
        return f"{self.median:.6g} ({self.global_avg:.6g})"


class ScalarWriter:
    """JSONL scalar sink, mirrored to TensorBoard when it imports."""

    def __init__(self, log_dir: str | None):
        self.jsonl = None
        self.tb = None
        if not log_dir:
            return
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        self.jsonl = open(Path(log_dir) / "scalars.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            self.tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self.jsonl:
            self.jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                         "time": time.time()}) + "\n")
        if self.tb:
            self.tb.add_scalar(tag, value, step)

    def flush(self) -> None:
        if self.jsonl:
            self.jsonl.flush()
        if self.tb:
            self.tb.flush()

    def close(self) -> None:
        self.flush()
        if self.jsonl:
            self.jsonl.close()
        if self.tb:
            self.tb.close()


class MetricLogger:
    """Epoch and eval cadence, best tracking, early stop.  Off the main
    rank (``is_main=False``) it prints nothing, writes no scalars and
    never calls ``save_fn``; it still tracks the best MSE and the stop, so
    every rank leaves the epoch loop together."""

    EPS = 1e-6

    def __init__(self, cfg, *, is_main: bool = True, save_fn=None):
        self.cfg = cfg
        self.is_main = is_main
        self.save_fn = save_fn  # callable(reason): saves a checkpoint

        self.stop_patience = cfg.scheduler.stop_patience
        self.best_mse = float("inf")
        cur = cfg.get("_cur_epoch", 0) or 0
        self.best_mse_epoch = cur - 1
        self.cur_epoch = cur - 1
        self.cur_step = 0
        self.timers = TimersManager("train", "epoch", "eval", "total")
        self.smooth: dict[str, SmoothedValue] = {}
        self.val_mse = MSEMetric(scale=cfg.mse_scale)
        self.last_val_mse = float("nan")
        self.writer = ScalarWriter(cfg.tensorboard if is_main else None)
        self.verbose = bool(cfg.verbose)
        self.timers.total.start()

    # ---- persistence ------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "timers": self.timers.state_dict(),
            "cur_step": self.cur_step,
            "best_mse": self.best_mse,
            "best_mse_epoch": self.best_mse_epoch,
        }

    def load_state_dict(self, state: dict) -> None:
        self.timers.load_state_dict(state["timers"])
        self.cur_step = state["cur_step"]
        self.best_mse = state["best_mse"]
        self.best_mse_epoch = state["best_mse_epoch"]

    def print(self, *args) -> None:
        if self.is_main:
            print(*args, flush=True)

    # ---- epoch ------------------------------------------------------------
    def start_epoch(self, epoch: int, n_batches: int, lr: float) -> None:
        self.cur_epoch = epoch
        self.print(f"[T_total={self.timers.total} | T_train={self.timers.train}] "
                   f"Start epoch {epoch} with lr={lr:g}")
        self.epoch_n_samples = 0
        self.sum_loss = 0.0
        self.sum_all_losses: dict[str, float] = {}
        self.n_batches = n_batches
        self.timers.epoch.start(reset=True)
        self.timers.train.start()

    def step_batch(self, i_batch, n_valid, total_loss, losses, lr) -> None:
        """Log one batch; ``total_loss`` and ``losses`` may be device
        scalars, read here (the only host sync of a logged batch)."""
        total_loss = float(total_loss)
        losses = {k: float(v) for k, v in sorted(losses.items())}
        for k, v in losses.items():
            self.smooth.setdefault(k, SmoothedValue()).update(v)
        self.smooth.setdefault("total_loss", SmoothedValue()).update(total_loss)

        self.sum_loss += total_loss * n_valid
        self.epoch_n_samples += n_valid
        for k, v in losses.items():
            self.sum_all_losses[k] = self.sum_all_losses.get(k, 0.0) + v * n_valid

        self.writer.add_scalar("Loss/train", total_loss, self.cur_step)
        self.writer.add_scalar("hparam/lr", lr, self.cur_step)
        for k, v in losses.items():
            self.writer.add_scalar(f"Loss/{k}", v, self.cur_step)

        if self.verbose and self.is_main:
            losses_str = " ; ".join(f"{k}={v}" for k, v in self.smooth.items())
            print("\033[K"
                  f"[T_total={self.timers.total} | T_train={self.timers.train} | "
                  f"T_epoch={self.timers.epoch}] "
                  f"train {i_batch + 1} / {self.n_batches} (step {self.cur_step}) "
                  f"lr={lr:g} loss={self.smooth['total_loss']} "
                  f"(avg={self.sum_loss / max(self.epoch_n_samples, 1):g}) "
                  f"[[{losses_str}]]", end="\r", flush=True)
        self.cur_step += 1

    def end_train_phase(self) -> None:
        self.timers.train.stop()
        if self.verbose and self.is_main:
            print(flush=True)

    def end_epoch(self, val_mse: float, usage_rows=None, *, mean_loss: float | None = None,
                  mean_all: dict | None = None) -> bool:
        """Returns True if this epoch is the new best (checkpoint saved).
        ``mean_loss`` / ``mean_all`` replace the sums of the logged batches
        with the exact means the train loop summed on the device."""
        if mean_loss is None:
            mean_loss = self.sum_loss / max(self.epoch_n_samples, 1)
        if mean_all is None:
            mean_all = {k: v / max(self.epoch_n_samples, 1)
                        for k, v in self.sum_all_losses.items()}
        losses_str = " ; ".join(f"{k}={v:g}" for k, v in sorted(mean_all.items()))

        is_best = val_mse < self.best_mse - self.EPS
        if is_best:
            self.best_mse = val_mse
            self.best_mse_epoch = self.cur_epoch

        self.print(f"[T_total={self.timers.total} | T_train={self.timers.train} | "
                   f"T_epoch={self.timers.epoch}] End of epoch {self.cur_epoch} "
                   f"({self.cur_step} steps) train loss {mean_loss:g}")
        self.print(f"All losses: [[{losses_str}]]")
        self.print(f"Validation metrics: [[MSE={val_mse:g}]]")
        self.print(f"Best metrics: [[min_MSE={self.best_mse:g}]]")

        if is_best and self.save_fn is not None and self.is_main:
            self.print("Best validation MSE so far, storing model")
            self.save_fn("best")

        self.writer.add_scalar("Loss/mean", mean_loss, self.cur_step)
        self.writer.add_scalar("MSE/val", val_mse, self.cur_step)
        self.writer.add_scalar("MSE/best", self.best_mse, self.cur_step)

        if usage_rows is not None and sum(len(u) for u in usage_rows) > ENTROPY_MAX_CODES:
            usage_rows = None
        if usage_rows is not None:
            ent = codebook_entropy(usage_rows)
            if ent:
                self.print(f"train_codeword_entropy={np.mean(ent):g} (min={min(ent):g})"
                           "  |  step_entropies=[" + ", ".join(f"{e:.2f}" for e in ent) + "]")
                self.writer.add_scalar("entropy/train_entropy", np.mean(ent), self.cur_step)
        self.writer.flush()
        return is_best

    def should_stop(self) -> bool:
        if self.cur_epoch - self.best_mse_epoch > self.stop_patience:
            self.print(f"Val loss did not improve for {self.stop_patience} epochs, stopping")
            return True
        if (self.cfg.scheduler.name == "cosine"
                and self.cur_epoch >= self.cfg.epochs + self.stop_patience):
            self.print("Reached maximum epochs for cosine scheduler, stopping")
            return True
        return False

    # ---- eval -------------------------------------------------------------
    def start_eval(self, n_batches: int) -> None:
        self.n_eval_batches = n_batches
        self.timers.eval.start(reset=True)
        self.val_mse.reset()

    def step_eval_sums(self, i_batch: int, sq_err_sum: float, n_valid: int) -> None:
        """Eval progress from a batch's squared-error sum."""
        self.val_mse.update_sums(sq_err_sum, n_valid)
        if self.verbose and self.is_main:
            print("\033[K"
                  f"[T_total={self.timers.total} | T_eval={self.timers.eval}] "
                  f"inference on validation split {i_batch + 1} / {self.n_eval_batches} "
                  f"[[MSE={self.val_mse.compute():g}]]", end="\r", flush=True)

    def end_eval(self) -> float:
        self.timers.eval.stop()
        if self.verbose and self.is_main:
            print(flush=True)
        self.last_val_mse = self.val_mse.compute()
        return self.last_val_mse

    def close(self) -> None:
        self.writer.close()
