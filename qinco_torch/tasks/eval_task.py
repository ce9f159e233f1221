"""Database MSE evaluation (``eval``) and its timing harness
(``eval_time``) (counterpart of ``qinco_tpu/tasks/eval_task.py``).
``eval_time`` reports μs per vector after a warm-up, with device syncs
around each encode and decode; with ``profile_dir`` it also writes a
``torch.profiler`` trace there (``trace.json``) and, beside it, the
program's own spans and counters recorded under the profiler
(``spans.json``, :func:`qinco_torch.tracing.export`: a Chrome trace on
the same clock, ``ts`` in µs after the profiler trace's start, which
``otherData.trace_start_ns`` gives; the encode's ``encode.ivf``,
``encode.step``, ``encode.backtrace``, the kernel wrappers'
``kernels.*`` and the uploads' ``io.upload``, the counters under
``otherData.counters``).  Over a process group each data group
evaluates its shard of the database, the MSE is the global one, and each
rank writes its own trace and spans (``trace_rank<r>.json``,
``spans_rank<r>.json``)."""

from __future__ import annotations

from pathlib import Path

from .. import tracing
from ..data.datasets import load_vec_db
from ..train.loop import compute_mse
from .base import BaseTask


class EvalTask(BaseTask):
    DISTRIBUTED = True

    def load_data(self):
        cfg = self.cfg
        self.print(f"Loading database from {cfg.db}")
        self.test_vecs, self.test_loader = load_vec_db(
            cfg, shard=(self.mesh.data_rank, self.mesh.data_size))
        self.print(f"Test set: {self.test_vecs.shape}")
        self.data_dim = self.test_vecs.shape[-1]

    def run(self):
        cfg = self.cfg
        timing = cfg.task == "eval_time"
        profile_dir = cfg.get("profile_dir")

        def _run():
            return compute_mse(self.params, self.spec, self.test_loader,
                               mse_scale=cfg.mse_scale, timing=timing, mesh=self.mesh)

        if timing and profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            tracing.clear()
            with profile(activities=activities) as prof:
                mse = _run()
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            rank = f"_rank{self.mesh.rank}" if self.mesh.grouped else ""
            prof.export_chrome_trace(str(Path(profile_dir) / f"trace{rank}.json"))
            tracing.export(Path(profile_dir) / f"spans{rank}.json")
            self.print(f"Wrote profiler trace to {profile_dir}")
        else:
            mse = _run()
        self.print(f"Test metrics: [[MSE={mse:g}]]")
        return mse
