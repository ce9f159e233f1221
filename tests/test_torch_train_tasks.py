"""The port's tasks through ``python -m qinco_torch``'s ``main`` with
``cpu=true``, on the tiny clusterable data of ``tests/test_tasks_e2e.py``:
train, eval_valset, eval, eval_time and resume, and checkpoints that cross
between the packages.

A JAX-trained checkpoint evaluated by the port's ``task=eval`` gives the
JAX package's MSE within rtol 1e-4 (f32, exact encode on both sides)."""

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

from qinco_torch.__main__ import main
from qinco_torch.config import load_config
from qinco_torch.models.params import param_leaves
from qinco_torch.tasks import get_task
from qinco_torch.tasks.base import BaseTask
from qinco_torch.tasks.train_task import TrainTask
from qinco_torch.train.loop import compute_mse

MODEL = ["M=4", "K=16", "L=1", "de=8", "dh=16", "A=4", "B=2"]
RUN = ["batch=256", "ds.valset=256", "scheduler.stop_patience=0", "lr=0.004", "verbose=false",
       "cpu=true"]


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(32, 16)).astype(np.float32) * 3
    assign = rng.integers(0, 32, size=3000)
    x = centers[assign] + 0.3 * rng.normal(size=(3000, 16)).astype(np.float32)
    path = tmp / "train.npy"
    np.save(path, x)
    return path


def test_train_eval_resume_cycle(tiny_data, tmp_path):
    out = tmp_path / "model.npz"
    common = [f"trainset={tiny_data}", f"output={out}", *MODEL, *RUN]
    assert main(["task=train", "epochs=2", *common]) == 0
    assert out.exists()
    # the checkpoint's hyper-parameters fill the config: no model arguments
    assert main(["task=eval_valset", f"trainset={tiny_data}", f"model={out}",
                 f"output={tmp_path / 'unused.npz'}", *RUN]) == 0
    assert main(["task=eval", f"db={tiny_data}", f"model={out}", "ds.db=512", *RUN]) == 0
    trace = tmp_path / "trace"
    assert main(["task=eval_time", f"db={tiny_data}", f"model={out}", "ds.db=512",
                 f"profile_dir={trace}", *RUN]) == 0
    assert any(trace.rglob("*.json"))
    assert main(["task=train", "resume=true", "epochs=3", *common]) == 0
    with pytest.raises(ValueError, match="conflicts with checkpoint"):
        main(["task=eval", f"db={tiny_data}", f"model={out}", "K=32", *RUN])


def test_training_improves_val_mse(tiny_data, tmp_path):
    cfg = load_config(["task=train", f"trainset={tiny_data}", f"output={tmp_path / 'm.npz'}",
                       *MODEL, *RUN, "epochs=5"])
    task = TrainTask(cfg)
    initial = compute_mse(task.params, task.spec, task.val_loader, mse_scale=cfg.mse_scale)
    best = task.run()
    assert np.isfinite(best)
    assert best < initial * 0.7, f"trained {best} vs initial {initial}"


def _train(tiny_data, out, *extra):
    cfg = load_config(["task=train", f"trainset={tiny_data}", f"output={out}", *MODEL, *RUN,
                       *extra])
    task = TrainTask(cfg)
    task.run()
    return task


def test_resumed_run_equals_uninterrupted_run(tiny_data, tmp_path):
    """Epochs 0-2 in one run against epochs 0-1, then 2 resumed from the
    checkpoint (the ramp's 3 epochs make the learning rates equal whatever
    ``epochs`` says)."""
    whole = _train(tiny_data, tmp_path / "whole.npz", "epochs=2")
    out = tmp_path / "split.npz"
    _train(tiny_data, out, "epochs=1")
    resumed = _train(tiny_data, out, "epochs=2", "resume=true")
    for a, b in zip(param_leaves(whole.params), param_leaves(resumed.params)):
        assert torch.equal(a, b)
    for a, b in zip(whole.mstate, resumed.mstate):
        assert torch.equal(a, b)


def test_jax_trained_checkpoint_evaluates_to_jax_mse(tiny_data, tmp_path):
    from qinco_tpu.config import load_config as jax_config
    from qinco_tpu.tasks import get_task as jax_get_task

    import run_qinco

    model = tmp_path / "jax.npz"
    assert run_qinco.main(["task=train", f"trainset={tiny_data}", f"output={model}", *MODEL,
                           *RUN, "epochs=0"]) in (0, None)
    args = ["task=eval", f"db={tiny_data}", f"model={model}", "ds.db=768", "batch=256",
            "verbose=false"]
    want = jax_get_task("eval")(jax_config(args)).run()
    got = get_task("eval")(load_config([*args, "cpu=true"])).run()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_jax_trainer_resumes_from_a_port_checkpoint(tiny_data, tmp_path, capsys):
    """The JAX trainer resumes a port run at the port's next epoch: it reads
    the params, model state, scheduler and logger, and starts a fresh
    optimizer, since the port's optimizer leaves are not ``opt_*``."""
    from qinco_tpu.checkpoint import load_checkpoint_meta

    import run_qinco

    out = tmp_path / "port.npz"
    common = [f"trainset={tiny_data}", f"output={out}", *MODEL, *RUN]
    assert main(["task=train", "epochs=1", *common]) == 0
    meta = load_checkpoint_meta(out)
    assert meta["counts"].get("opt", -1) < 0 and meta["counts"]["torchopt"] > 0
    capsys.readouterr()
    assert run_qinco.main(["task=train", "resume=true", f"epochs={meta['epoch'] + 1}",
                           *common]) in (0, None)
    printed = capsys.readouterr().out
    assert f"Start epoch {meta['epoch']} " in printed and "Start epoch 0 " not in printed


# The task names of the JAX package's registry (qinco_tpu/tasks/base.py).
JAX_TASKS = ["train", "eval_valset", "eval", "eval_time", "convert", "ivf_centroids", "encode",
             "build_index", "train_pairwise_decoder", "search", "train_pq", "eval_pq",
             "encode_codec", "decode_codec", "search_2stage"]


@pytest.mark.parametrize("name", JAX_TASKS)
def test_every_task_of_the_jax_registry_resolves(name):
    from qinco_tpu.tasks import get_task as jax_get_task

    task = get_task(name)
    assert isinstance(task, type) and issubclass(task, BaseTask)
    assert task.__name__ == jax_get_task(name).__name__
