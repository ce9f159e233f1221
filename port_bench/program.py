"""The program under test, ``qinco_torch``, as the benchmark drives it:
its configuration, spec and parameters made from a configuration file and
the benchmark's weights.  The only module of the benchmark besides the
drivers that imports the program; the reference never does."""

from __future__ import annotations

from qinco_torch.config import load_config
from qinco_torch.models import qinco
from qinco_torch.models.params import QincoParams, StepParams, init_model_state
from qinco_torch.models.spec import spec_from_cfg
from qinco_torch.ops import kernels
from qinco_torch.train import train_step
from qinco_torch.utils import host_to_device

MODEL_KEYS = ("M", "K", "L", "de", "dh", "A", "B", "ivf_K")
TRAIN_KEYS = ("batch", "optimizer", "lr", "wd", "grad_clip")

__all__ = ["qinco", "kernels", "train_step", "host_to_device", "init_model_state", "config",
           "spec", "params"]


def config(cfg: dict):
    """The program's configuration: its defaults, the file's model sizes,
    training settings and encode profile, with the IVF step in use."""
    overrides = [f"{k}={cfg[k]}" for k in MODEL_KEYS + TRAIN_KEYS]
    return load_config(overrides + ["ivf_in_use=true", f"encode_profile={cfg['encode_profile']}"])


def spec(cfg: dict):
    return spec_from_cfg(config(cfg), D=cfg["D"])


def params(W: dict) -> QincoParams:
    """The program's parameters holding the benchmark's very tensors."""
    steps = StepParams(codebook=W["codebook"], sub_codebook=W["sub_codebook"],
                       concat_w=W["concat_w"], concat_w2=None, concat_b=W["concat_b"],
                       ffn_up=W["ffn_up"], ffn_down=W["ffn_down"], in_proj=W["in_proj"],
                       out_proj=W["out_proj"])
    return QincoParams(W["codebook0"], steps, W["data_mean"], W["data_std"])
