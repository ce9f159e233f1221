"""The ``train`` traffic kind: one training job, a closed loop of steps.

Each call is one step of ``qinco_torch.train.train_step.make_train_step``
at the configuration's batch, optimizer, learning rate, weight decay and
clip, on the next rows of a seeded order over a host array of the
configuration's ``db_rows`` seeded vectors, copied up with
``qinco_torch.utils.host_to_device`` as the train task does.  A step is
whole: the copy, the no-grad encode (with the IVF step 0), the losses,
backward and AdamW.  Nothing in it reads back to the host; the window's
end waits for the device.

Set-up builds the one step object (parameters, optimizer, model state)
and drives it through its first ``check_steps`` steps, on rows that all
differ, through the window's own call; then the window goes on with the
same object.  ``correct`` holds those first steps against the
reference's (``checks.py``): each step's loss, the first gradient as the
optimizer holds it (AdamW's first moment after one step over 1 - beta1),
the first step's codes and the weights after the last.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

import checks
import gen
import harness
import program
import work
from reference import qinco_ref


def run(ctx) -> dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    shp = qinco_ref.Shape.of(cfg)
    W = gen.random_weights(shp, ctx.seed, dev)
    start_print = gen.fingerprint(W)
    ctx.mark("weights")
    host = gen.synthetic_data(W, shp, cfg["db_rows"], ctx.seed, cfg["data_noise"])
    batch = cfg["batch"]
    order = gen.BatchOrder(ctx.seed, len(host), batch)
    ctx.mark("data")
    pcfg, spec = program.config(cfg), program.spec(cfg)
    ctx.reset_peak()
    state = {"params": program.params(W), "i": 0}
    opt = program.train_step.build_optimizer(pcfg, state["params"], spec)
    step = program.train_step.make_train_step(spec, opt, pcfg.grad_clip)
    state["mstate"] = program.init_model_state(spec, device=dev)
    ones = np.ones((batch,), np.float32)
    losses, host_ms = [], []

    def call() -> int:
        xb = program.host_to_device(host[order.rows(state["i"])], dev)
        wb = program.host_to_device(ones, dev)
        t = time.perf_counter()
        state["params"], state["mstate"], out = step(state["params"], state["mstate"], xb, wb)
        host_ms.append((time.perf_counter() - t) * 1e3)
        state["i"] += 1
        losses.append(out.total_loss)
        state["codes"] = out.codes
        return batch

    names = qinco_ref.trainable(W)
    beta1 = opt.param_groups[0]["betas"][0]
    call()
    ctx.sync()
    ctx.mark("first_step")
    moments = {k: opt.state.get(W[k], {}).get("exp_avg", torch.zeros_like(W[k])) for k in names}
    first_grads = {k: m.detach().to("cpu") / (1 - beta1) for k, m in moments.items()}
    first_codes = state.pop("codes").to("cpu")
    for _ in range(tr["check_steps"] - 1):
        call()
    ctx.sync()
    after = {k: W[k].detach().to("cpu", copy=True) for k in names}
    first_losses = [float(v) for v in losses]
    setup_s = ctx.elapsed()

    del losses[:], host_ms[:]
    win = harness.run(call, ctx.seconds, ctx.sync, ctx.trace, tr["trace_active_calls"])
    peak = ctx.peak()
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    obs = dict(kind="train", rate=win.rate, trace=win.trace, batch=batch,
               work=work.work_spec(cfg), step_host_ms=statistics.mean(
                   host_ms[i] for i in win.plain))
    del state, opt, step, W, losses
    ctx.free()

    W0 = gen.random_weights(shp, ctx.seed, dev)
    batches = [torch.from_numpy(host[order.rows(i)]).to(dev)
               for i in range(tr["check_steps"])]
    ref = qinco_ref.train_steps(W0, shp, batches, cfg["lr"], cfg["wd"], cfg["grad_clip"])
    readings = checks.train_readings(
        {"losses": first_losses, "grads": first_grads, "codes": first_codes, "weights": after},
        ref, W0)
    if not finite or gen.fingerprint(W0) != start_print:
        readings.update(loss_gap=float("inf"))
    return dict(setup_s=setup_s, attempted=win.calls, failed=0,
                e2e={"train_vec_per_s": win.rate}, readings=readings, obs=obs,
                window=win, memory_peak_bytes=peak)
