"""The ``db_encode`` traffic kind: one client encodes a database shard after
shard, as a DB-encode job does, in a closed loop.

Each call is ``qinco_torch.models.qinco.encode_chunked(params, spec,
shard, batch=...)`` over the next ``encode_shard_rows`` rows (the
configuration's) of a host array of the configuration's ``db_rows``
seeded vectors, wrapping round at its end; it returns when the shard's codes are on the host.  Set-up makes the
weights and the data from the seed and encodes ``warm_rows`` rows, which
builds and loads the kernels and warms every shape the window uses.

``correct``: a sample of ``check_rows`` of the window's vectors, drawn
from the seed, encoded again by the reference (``checks.py``).
"""

from __future__ import annotations

import numpy as np
import torch

import checks
import gen
import harness
import program
import work
from reference import qinco_ref

IVF_SPAN = "bench.ivf_step0"


def ivf_span(fn):
    """``fn()`` with the benchmark's span around each call of the IVF step 0
    (``chunked_argmin``, as ``qinco_torch.models.qinco.encode`` calls it)."""
    orig = program.qinco.chunked_argmin

    def spanned(*args, **kw):
        with torch.profiler.record_function(IVF_SPAN):
            return orig(*args, **kw)

    program.qinco.chunked_argmin = spanned
    try:
        return fn()
    finally:
        program.qinco.chunked_argmin = orig


def run(ctx) -> dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    shp = qinco_ref.Shape.of(cfg)
    W = gen.random_weights(shp, ctx.seed, dev)
    ctx.mark("weights")
    host = gen.synthetic_data(W, shp, cfg["db_rows"], ctx.seed, cfg["data_noise"])
    n_rows, batch = len(host), tr["batch"]
    shard = cfg["encode_shard_rows"]
    ctx.mark("data")
    spec, params = program.spec(cfg), program.params(W)
    ctx.reset_peak()
    program.qinco.encode_chunked(params, spec, host[:tr["warm_rows"]], batch=batch)
    ctx.sync()
    setup_s = ctx.elapsed()

    outs, pos = [], [0]

    def call() -> int:
        i = pos[0]
        xs = host[i:i + shard] if i + shard <= n_rows else np.concatenate(
            [host[i:], host[:i + shard - n_rows]])
        outs.append((i, program.qinco.encode_chunked(params, spec, xs, batch=batch)))
        pos[0] = (i + shard) % n_rows
        return shard

    win = harness.run(call, ctx.seconds, ctx.sync, ctx.trace, tr["trace_active_calls"],
                      spans=ivf_span)
    peak = ctx.peak()
    obs = dict(kind="encode", rate=win.rate, trace=win.trace, batch=batch,
               chunks=win.active_n // batch, work=work.work_spec(cfg),
               tf32=bool(torch.backends.cuda.matmul.allow_tf32))
    del params, W, spec
    ctx.free()

    # the check: a sample of the window's vectors, drawn from the seed
    total = len(outs) * shard
    rng = np.random.default_rng([ctx.seed, 5])
    pick = np.sort(rng.choice(total, size=min(tr["check_rows"], total), replace=False))
    k, off = np.divmod(pick, shard)
    rows = (np.array([outs[j][0] for j in k]) + off) % n_rows
    codes = np.stack([outs[j][1][:, o] for j, o in zip(k, off)], axis=1)
    W = gen.random_weights(shp, ctx.seed, dev)
    x = checks.normalized(W, torch.from_numpy(host[rows]).to(dev))
    ref = qinco_ref.encode(W, shp, x)
    readings = checks.encode_readings(W, shp, x, torch.from_numpy(codes).to(dev), ref)
    return dict(setup_s=setup_s, attempted=total, failed=0,
                e2e={"encode_vec_per_s": win.rate}, readings=readings, obs=obs,
                window=win, memory_peak_bytes=peak)
