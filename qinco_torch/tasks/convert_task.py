"""Convert a reference torch checkpoint (``.pt``) into the npz format
(counterpart of ``qinco_tpu/tasks/convert_task.py``).

``data_mean`` and ``data_std`` come from the checkpoint when it carries
them; for a QINCo1-era checkpoint that does not, ``db=<name>`` takes the
reference's per-dataset normalization statistics, kept as a binary asset
(``assets/v1_dataset_norms.npz``, the port's own copy of the JAX
package's file).
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

from ..checkpoint import load_torch_checkpoint, params_from_torch_state
from ..models.spec import spec_from_cfg
from .base import BaseTask

_V1_NORMS_PATH = pathlib.Path(__file__).parent.parent / "assets" / "v1_dataset_norms.npz"


def v1_dataset_norms(db: str):
    """(dim, mean (D,), std) for a QINCo1-era dataset name, or None.  A 1B
    name takes its 1M statistics (bigann1B -> bigann1M), as the reference
    does."""
    name = db.replace("1B", "1M")
    with np.load(_V1_NORMS_PATH) as z:
        if f"{name}__dim" not in z:
            return None
        return (int(z[f"{name}__dim"]), np.asarray(z[f"{name}__mean"], np.float32),
                float(z[f"{name}__std"]))


class ConvertTask(BaseTask):
    USE_MODEL = False

    def run(self):
        cfg = self.cfg
        if not cfg.model:
            raise ValueError("Specify the .pt checkpoint via 'model'")
        if not (cfg.output and str(cfg.output).endswith(".npz")):
            raise ValueError("Specify a .npz output path")

        model_sd, meta = load_torch_checkpoint(cfg.model)
        for arg, val in meta["parameters"].items():
            if cfg.get(arg) is None:
                cfg[arg] = val
        db_name = cfg.get("db_name") or cfg.get("db")
        if db_name and "data_mean" not in model_sd:
            # a QINCo1-era checkpoint: the normalization lives in the
            # reference's per-dataset tables, not in the state dict
            norms = v1_dataset_norms(str(db_name))
            if norms is None:
                raise ValueError(f"No v1 normalization stats for db={db_name!r}; known: "
                                 "bigann1M, deep1M, contriever1M, FB_ssnpp1M (or 1B variants)")
            _, mean, std = norms
            model_sd["data_mean"] = mean
            model_sd["data_std"] = np.float32(std)
        D = meta.get("data_dim")
        if D is None:
            D = model_sd["data_mean"].shape[0]
        # QINCo1-era layouts: the in/out projections live inside
        # residual_blocks.{l}, and step 0 may carry an unused substep codebook
        model_sd = {re.sub(r"residual_blocks\.[0-9]+\.(in_proj|out_proj)", r"\1", k): w
                    for k, w in model_sd.items()}
        model_sd.pop("steps.0.substep.codebook.weight", None)
        if cfg.ivf_centroids:
            cfg.ivf_in_use = True
            cfg.ivf_K = self.ivf_centroids.shape[0]
            # side-file centroids are already in normalized space
            model_sd.setdefault("steps.0.ivf_centroids.weight",
                                np.asarray(self.ivf_centroids, np.float32))
        if not cfg.get("ivf_in_use") and any("ivf_centroids" in k for k in model_sd):
            cfg.ivf_in_use = True

        self.spec = spec_from_cfg(cfg, int(D))
        self.params, self.mstate = params_from_torch_state(model_sd, self.spec,
                                                           device=self.device)
        self.save(epoch=meta.get("epoch"))
        self.print(f"Converted {cfg.model} -> {cfg.output}")
