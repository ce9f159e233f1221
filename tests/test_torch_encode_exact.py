"""The exact profile (``encode_profile=exact``: plain float32 beam search)
in the port against the JAX package's ``encode``, same weights and data.

Backends are never compared bit for bit (docs/tests.md): codes must agree
on >= 99% of entries and the reconstruction MSEs within 1e-4 relative."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import data, make_models, mse

from qinco_torch.models import qinco as tq
from qinco_torch.train.loop import compute_mse
from qinco_tpu.models import qinco as jq
from qinco_tpu.train.loop import compute_mse as jax_compute_mse

SPECS = {
    "beam": dict(),
    "greedy": dict(B=1),
    "no_substep": dict(A=0, B=4),
    "ivf_beam": dict(ivf_K=128),
    "ivf_greedy": dict(ivf_K=128, B=1),
    "ivf_no_substep": dict(ivf_K=128, A=0, B=4),
    "projections": dict(de=48),
    "fast_plain": dict(fast=True),  # bf16-rounded candidate fetch, plain route
    # Contriever's width (D = 768) at the qinco2-L MLP widths, one FFN
    # block: deeper, the decodes grow past the 1e-5 atol of the decode check
    "contriever_L": dict(D=768, K=256, M=2, L=1, de=384, dh=384, A=8, B=4),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_exact_encode_matches_jax(name):
    js, ts, jp, tp, _ = make_models(seed=2, **SPECS[name])
    x = data(96, js.D, seed=5)
    cj, xj, _ = jq.encode(jp, js, jnp.asarray(x))
    ct, xt, _ = tq.encode(tp, ts, torch.from_numpy(x))
    cj, ct = np.asarray(cj), ct.numpy()
    assert ct.shape == cj.shape == (js.M_ivf, 96) and ct.dtype == np.int32
    assert (ct == cj).mean() >= 0.99
    mj, mt = mse(x, xj), mse(x, xt.numpy())
    assert abs(mt - mj) <= 1e-4 * mj, (mt, mj)
    # encode's reconstruction is the decode of its codes (the fast route
    # reconstructs from bf16-rounded codewords, so only without it)
    if not ts.fast:
        np.testing.assert_allclose(tq.decode(tp, ts, torch.from_numpy(ct)).numpy(),
                                   xt.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["beam", "ivf_beam"])
def test_encode_stats_match_jax(name):
    js, ts, jp, tp, _ = make_models(seed=6, **SPECS[name])
    x = data(40, js.D, seed=7)
    w = (np.arange(40) < 33).astype(np.float32)  # 7 padded rows
    for weights in (None, w):
        _, _, sj = jq.encode(jp, js, jnp.asarray(x), weights=None if weights is None
                             else jnp.asarray(weights), want_stats=True)
        _, _, st = tq.encode(tp, ts, torch.from_numpy(x), weights=None if weights is None
                             else torch.from_numpy(weights), want_stats=True)
        for a, b in zip(st, sj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_encode_chunked_matches_one_shot_and_raw_space():
    js, ts, jp, tp, _ = make_models(seed=8, ivf_K=128)
    x = data(75, js.D, seed=9, scale=2.0)
    one = tq.encode_raw(tp, ts, torch.from_numpy(x)).numpy()
    chunked = tq.encode_chunked(tp, ts, x, batch=32)
    assert (chunked == one).all()
    want = np.asarray(jq.encode_chunked(jp, js, x, batch=32))
    assert (chunked == want).mean() >= 0.99
    assert tq.default_encode_batch(ts) == jq.default_encode_batch(js)


def test_compute_mse_matches_jax(capsys):
    js, ts, jp, tp, _ = make_models(seed=10)
    x = data(70, js.D, seed=11)
    batches = []
    for i in range(0, 70, 32):
        xb = np.zeros((32, js.D), np.float32)
        xb[: len(x[i:i + 32])] = x[i:i + 32]
        batches.append(SimpleNamespace(x=xb, n_valid=len(x[i:i + 32])))
    got = compute_mse(tp, ts, batches, mse_scale=2.0, timing=True, warmup_batches=1)
    assert "Encoding time / vector" in capsys.readouterr().out
    want = jax_compute_mse(jp, js, batches, mse_scale=2.0)
    assert abs(got - want) <= 1e-4 * want
