"""Task lifecycle: setup -> load_data -> load_model -> run, and the task
registry (counterpart of ``qinco_tpu/tasks/base.py``).

A task runs on the CUDA device, or on the CPU with ``cpu=true``.  Under a
process group (``qinco_torch/parallel``) each rank runs it on its own card
(``cuda:<local rank>``) over the ``(mesh.data, mesh.model)`` mesh; only
the main rank prints and saves.  The tasks with ``DISTRIBUTED = False``
run in one process only."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..checkpoint import SAVED_PARAMETERS, load_checkpoint, load_checkpoint_meta, save_checkpoint
from ..config import Config, apply_dataset_preset
from ..models.params import init_model_state, init_params, set_codebooks_from_rq
from ..models.spec import spec_from_cfg
from ..parallel.mesh import make_mesh
from ..utils import format_memory, resolve_device


class BaseTask:
    USE_MODEL = True
    DISTRIBUTED = False  # True: the task runs over several ranks

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.setup()
        self.load_data()
        if self.USE_MODEL:
            self.load_model()

    # -- lifecycle ----------------------------------------------------------
    def setup(self) -> None:
        cfg = self.cfg
        self.mesh = make_mesh(cfg.mesh.data, cfg.mesh.model)
        self.process_index, self.process_count = self.mesh.rank, self.mesh.world
        self.is_main = self.mesh.is_main
        if self.process_count > 1 and not self.DISTRIBUTED:
            raise ValueError(f"task={cfg.task} runs in one process; start it without a "
                             f"process group ({self.process_count} ranks)")
        if cfg.cpu:
            self.device = torch.device("cpu")
        elif self.mesh.grouped:  # the card that the group start-up made current
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = resolve_device()
        np.random.seed(cfg.seed)
        apply_dataset_preset(cfg)

        # The checkpoint's hyper-parameters fill what the config leaves unset;
        # a structural one that the config sets otherwise is an error.
        self.ckpt_meta = None
        if cfg.resume and cfg.task == "train" and cfg.output and Path(cfg.output).exists():
            cfg.model = cfg.output
            self.print(f"Resuming from {cfg.output}")
        if (cfg.model and Path(cfg.model).exists() and str(cfg.model).endswith(".npz")
                and not str(cfg.model).endswith(".pqnpz")):
            meta = load_checkpoint_meta(cfg.model)
            self.ckpt_meta = meta
            for arg, val in meta.get("parameters", {}).items():
                if cfg.get(arg) is None:
                    cfg[arg] = val
                elif arg == "A" and cfg[arg] and not val:
                    raise ValueError(
                        "Can't evaluate a model trained with A=0 using a non-zero A value.")
                elif arg in ("K", "M", "L", "de", "dh", "ivf_K") and cfg[arg] != val:
                    raise ValueError(
                        f"Config {arg}={cfg[arg]} conflicts with checkpoint {arg}={val}; "
                        "structural hyperparameters cannot be overridden at load time.")
                elif arg == "A" and not cfg[arg] and val:
                    raise ValueError(
                        f"Can't evaluate with A=0 a model trained with A={val} "
                        "(substep codebooks present).")
            self.data_dim = meta.get("data_dim")

        # IVF centroids imply an IVF model.
        self.ivf_centroids = None
        if cfg.ivf_centroids:
            self.ivf_centroids = np.load(cfg.ivf_centroids)
            cfg.ivf_in_use = True
            cfg.ivf_K, self.data_dim = self.ivf_centroids.shape

        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.print(f"Device: {self.device} ({name})")
        if self.mesh.grouped:
            m = self.mesh
            self.print(f"Process group: {m.world} rank(s), mesh data={m.data_size} x "
                       f"model={m.model_size}")
        self.log_device_memory()

    def log_device_memory(self) -> None:
        if self.is_main and self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            self.print(f"Device memory: {format_memory(total - free)} / "
                       f"{format_memory(total)} in use")

    def print(self, *args) -> None:
        if getattr(self, "is_main", True):
            print(*args, flush=True)

    def load_data(self) -> None:
        pass

    def load_model(self) -> None:
        """Fresh parameters from ``torch.Generator(device).manual_seed(seed)``
        and the data statistics; then on a fresh training run the RQ
        bootstrap; the IVF centroids normalized into step 0; last, the
        checkpoint ``cfg.model`` if there is one."""
        cfg = self.cfg
        self.spec = spec = spec_from_cfg(cfg, self.data_dim)
        g = torch.Generator(device=self.device).manual_seed(int(cfg.seed))
        data_mean, data_std = self.compute_data_stats()
        self.params = init_params(spec, g, device=self.device, data_mean=data_mean,
                                  data_std=data_std)
        self.mstate = init_model_state(spec, device=self.device)

        if cfg.task == "train" and not cfg.model:
            rq_centroids = self.train_rq_init()
            if rq_centroids is not None:
                self.params = set_codebooks_from_rq(g, self.params, spec, rq_centroids,
                                                    noise_init=cfg.codebook_noise_init)

        if self.ivf_centroids is not None:
            # IVF centroids live in normalized space inside the model
            ivf = torch.as_tensor(self.ivf_centroids, dtype=torch.float32, device=self.device)
            self.params = self.params._replace(
                codebook0=(ivf - self.params.data_mean) / self.params.data_std)

        self.restored = None
        if cfg.model and Path(cfg.model).exists():
            self.restored = self.restore_checkpoint(cfg.model)

    def compute_data_stats(self):
        return None, None

    def train_rq_init(self):
        return None

    # -- checkpointing ------------------------------------------------------
    def hyperparams_dict(self) -> dict:
        cfg = self.cfg
        return {p: cfg.get(p) for p in SAVED_PARAMETERS if cfg.get(p) is not None}

    def save(self, *, epoch=None, opt_state=None, scheduler_state=None,
             logger_state=None) -> None:
        if not self.is_main:
            return
        save_checkpoint(
            self.cfg.output, params=self.params, model_state=self.mstate, opt_state=opt_state,
            epoch=epoch, scheduler_state=scheduler_state, logger_state=logger_state,
            hyperparams=self.hyperparams_dict(), data_dim=self.spec.D)

    def restore_checkpoint(self, path) -> dict:
        restored = load_checkpoint(path, self.spec, device=self.device)
        self.params = restored["params"]
        if restored["mstate"] is not None:
            self.mstate = restored["mstate"]
        self.print(f"Loaded model checkpoint from {path}")
        return restored

    def run(self):
        raise NotImplementedError


def get_task(name: str):
    from . import codec_task, convert_task, eval_task, pq_task, search_tasks, train_task

    registry = {
        "train": train_task.TrainTask,
        "eval_valset": train_task.TrainTask,  # the train task's eval path
        "eval": eval_task.EvalTask,
        "eval_time": eval_task.EvalTask,
        "convert": convert_task.ConvertTask,
        "ivf_centroids": search_tasks.IVFTrainTask,
        "encode": search_tasks.EncodeDBTask,
        "build_index": search_tasks.BuildIndexTask,
        "train_pairwise_decoder": search_tasks.TrainPairwiseDecoderTask,
        "search": search_tasks.SearchTask,
        "train_pq": pq_task.PQTrainTask,
        "eval_pq": pq_task.PQEvalTask,
        "encode_codec": codec_task.EncodeCodecTask,
        "decode_codec": codec_task.DecodeCodecTask,
        "search_2stage": codec_task.TwoStageSearchTask,
    }
    if name not in registry:
        raise ValueError(f"Unknown task {name!r}; available: {sorted(registry)}")
    return registry[name]
