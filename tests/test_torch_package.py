"""The PyTorch port as a package: it stands alone (no JAX, nothing of
``qinco_tpu``), reads the same configs, runs on CUDA unless told
otherwise, and runs every encode route of the JAX package."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qinco_torch import config as tconfig
from qinco_torch.models import spec as tspec
from qinco_torch.models.params import init_params, params_from_numpy
from qinco_torch.models.qinco import encode
from qinco_torch.utils import resolve_device
from qinco_tpu import config as jconfig
from qinco_tpu.models import spec as jspec

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "qinco_torch").rglob("*.py")
) + ["chip_smoke.py", "scripts/torch_ktopa_breakdown.py", "scripts/torch_kernel_variants.py",
     "scripts/torch_scoring_times.py", "scripts/torch_timing.py",
     "scripts/torch_scale_regression.py", "scripts/torch_trained_mse_check.py"]


def test_imports_with_jax_and_qinco_tpu_absent():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['qinco_tpu'] = None\n"
        "import qinco_torch, qinco_torch.models, qinco_torch.checkpoint\n"
        "import qinco_torch.config, qinco_torch.ops.kernels, qinco_torch.train.loop\n"
        "import qinco_torch.train.train_step, qinco_torch.models.scheduler\n"
        "import qinco_torch.ops.kmeans, qinco_torch.ops.rq, qinco_torch.metrics\n"
        "import qinco_torch.logsys, qinco_torch.data, qinco_torch.__main__\n"
        "import qinco_torch.tasks.train_task, qinco_torch.tasks.eval_task\n"
        "import qinco_torch.ops.segment, qinco_torch.ops.aq, qinco_torch.tasks.search_tasks\n"
        "import qinco_torch.ops.breakdown\n"
        "import qinco_torch.search, qinco_torch.search.index, qinco_torch.search.index_build\n"
        "import qinco_torch.search.pairwise_decoder, qinco_torch.search.search\n"
        "import qinco_torch.search.operating_points, qinco_torch.search.optim_order\n"
        "import qinco_torch.codec, qinco_torch.ops.opq, qinco_torch.models.pq_qinco\n"
        "import qinco_torch.search.two_stage, qinco_torch.tasks.convert_task\n"
        "import qinco_torch.tasks.codec_task, qinco_torch.tasks.pq_task\n"
        "import qinco_torch.parallel, qinco_torch.parallel.mesh\n"
        "import qinco_torch.parallel.distributed, qinco_torch.parallel.sharded_ops\n"
        "assert qinco_torch.parallel.make_mesh().world == 1\n"
        "from qinco_torch.data import load_queries_data\n"
        "from qinco_torch.metrics import compute_recalls\n"
        "from qinco_torch.tasks import get_task\n"
        "assert get_task('train') and get_task('eval_time')\n"
        "for t in ('ivf_centroids', 'encode', 'build_index', 'train_pairwise_decoder', 'search',\n"
        "          'convert', 'train_pq', 'eval_pq', 'encode_codec', 'decode_codec',\n"
        "          'search_2stage'):\n"
        "    assert get_task(t)\n"
        "import chip_smoke\n"
        "from qinco_torch.models import QincoSpec, init_params, encode, decode\n"
        "spec = QincoSpec(D=8, K=16, M=2, L=1, de=8, dh=8, A=4, B=2)\n"
        "p = init_params(spec, device='cpu')\n"
        "x = __import__('torch').zeros((3, 8))\n"
        "codes, _, _ = encode(p, spec, x)\n"
        "assert decode(p, spec, codes).shape == (3, 8)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_qinco_tpu_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "qinco_tpu", "flax", "optax"), (path, name)


@pytest.mark.parametrize("entry", ["resolve_device", "init_params", "params_from_numpy"])
def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tspec.QincoSpec(D=8, K=16, M=2, L=1, de=8, dh=8, A=4, B=2)
    calls = {
        "resolve_device": lambda: resolve_device(),
        "init_params": lambda: init_params(spec),
        "params_from_numpy": lambda: params_from_numpy(
            spec, {n: np.zeros(1, np.float32) for n in
                   ("codebook0", "data_mean", "data_std", *[f"steps.{f}" for f in (
                       "codebook", "sub_codebook", "concat_w", "concat_b", "ffn_up",
                       "ffn_down")])}),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("script", ["torch_scale_regression", "torch_trained_mse_check"])
def test_scale_scripts_refuse_to_start_without_a_card(monkeypatch, tmp_path, script):
    """Without a card and without ``--device cpu`` the scale scripts stop
    before they write anything."""
    import importlib.util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location(script, ROOT / "scripts" / f"{script}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="--device cpu"):
        mod.main(["--out", str(out)] if script == "torch_scale_regression" else
                 ["--dir", str(out)])
    assert not out.exists()


OVERRIDES = [
    [],
    ["model_args=qinco2-S"],
    ["model_args=qinco2-M", "encode_profile=parity"],
    ["model_args=qinco2-L", "encode_profile=parity"],
    ["model_args=qinco2-L", "encode_profile=speed", "ivf_in_use=true"],
    ["model_args=qinco2-S", "encode_profile=speed", "ivf_in_use=true"],
    ["model_args=qinco1", "encode_profile=exact", "B=4", "ds.loop=1e-7"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: " ".join(o) or "defaults")
def test_config_and_spec_match_the_jax_package(overrides):
    jc, tc = jconfig.load_config(list(overrides)), tconfig.load_config(list(overrides))
    assert tc.to_dict() == jc.to_dict()
    if jc.K is not None:
        js, ts = jspec.spec_from_cfg(jc, D=128), tspec.spec_from_cfg(tc, D=128)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert (ts.M_ivf, ts.K_vals, ts.beam0, ts.n_codes_at(0), ts.n_codes_at(1)) == (
            js.M_ivf, js.K_vals, js.beam0, js.n_codes_at(0), js.n_codes_at(1))


def test_qinco2_L_preset_is_the_deep_spec_in_both_packages():
    """qinco2-L loads to D=128, K=256, M=8, L=16, de=dh=384, A=16, B=32
    in both packages, and the JAX package's selected-scores kernel takes
    its blocked form there (L > 4)."""
    from qinco_tpu.ops.pallas_kernels import _selected_perslot

    overrides = ["model_args=qinco2-L", "encode_profile=parity"]
    js = jspec.spec_from_cfg(jconfig.load_config(list(overrides)), D=128)
    ts = tspec.spec_from_cfg(tconfig.load_config(list(overrides)), D=128)
    want = dict(D=128, K=256, M=8, L=16, de=384, dh=384, A=16, B=32)
    assert {k: getattr(ts, k) for k in want} == {k: getattr(js, k) for k in want} == want
    assert (ts.pallas, ts.fast, ts.compute_dtype, ts.fused_select) == (
        True, True, "bfloat16", True)
    assert not _selected_perslot(js)


def test_spec_fields_match_the_jax_package():
    assert [f.name for f in dataclasses.fields(tspec.QincoSpec)] == [
        f.name for f in dataclasses.fields(jspec.QincoSpec)]


ROUTES = {
    "speed profile": dict(pallas=True, fast=True, fused_substep=True, perbin=True),
    "external vals": dict(pallas=True, fast=True, fused_topa=False),
    "candidate route": dict(pallas=True, fast=True, concat_rank=8),
    "approx_beam": dict(approx_beam=True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_match_jax(route):
    """Each route that once raised NotImplementedError in the port now
    encodes on the CPU, with the JAX package's codes on >= 95% of
    entries."""
    from torch_port_helpers import data, make_models

    from qinco_tpu.models import encode as jax_encode

    fields = dict(D=8, K=16, M=2, L=1, de=8, dh=8, A=4, B=2, **ROUTES[route])
    js, ts, jp, tp, _ = make_models(seed=3, **fields)
    x = data(32, 8, seed=4)
    codes, _, _ = encode(tp, ts, torch.from_numpy(x))
    assert codes.shape == (ts.M_ivf, 32), f"{route}: codes of shape {tuple(codes.shape)}"
    agree = (codes.numpy() == np.asarray(jax_encode(jp, js, x)[0])).mean()
    assert agree >= 0.95, f"{route}: the port's codes agree with JAX's on {agree:.3f} < 0.95"


def test_v1_norms_asset_is_the_ports_own_copy():
    """``task=convert`` reads the QINCo1-era norms from the port's own copy
    of the JAX package's asset, byte for byte the same file."""
    from qinco_torch.tasks import convert_task

    path = convert_task._V1_NORMS_PATH
    assert path.resolve().is_relative_to(ROOT / "qinco_torch")
    assert path.read_bytes() == (ROOT / "qinco_tpu/assets/v1_dataset_norms.npz").read_bytes()
