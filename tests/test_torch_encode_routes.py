"""The encode routes beyond the parity profile, in the port against the
JAX package's encode (Pallas kernels with ``interpret=True``); on the CPU
the port's beam step runs the kernels' plain versions.

- the speed profile (``encode_profile=speed``: fused_substep + perbin,
  the binned-argmin kernel);
- ``pallas=true`` alone (f32, the external-vals route with the folded
  table);
- ``pallas`` + ``fast`` with ``fused_topa=False`` (external vals, lean
  table; JAX on the CPU takes an exact top-A, as the port does);
- the candidate route: ``concat_rank`` (packed ids), K = 512 (no packed
  ids, the torch tail);
- ``approx_beam`` on the speed profile (exact per-step selection, then
  the final re-pick).

Codes agree on >= 99% of entries at f32 and >= 95% at bf16, and the
reconstruction MSEs within 1% (tests/test_torch_encode_parity.py).  With
XLA's excess precision off, in a subprocess, the speed profile with IVF
agrees on >= 99% of codes and to 1e-5 in the reconstructions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import data, jax_strict_bf16, make_models, mse

from qinco_torch.models import QincoSpec
from qinco_torch.models import qinco as tq
from qinco_torch.ops import kernels
from qinco_tpu.models import qinco as jq

SPEED = dict(pallas=True, fast=True, compute_dtype="bfloat16", fused_substep=True,
             perbin=True, fused_select=True)
CASES = {
    "speed_bf16": SPEED,
    "speed_bf16_ivf": dict(SPEED, ivf_K=128),
    "speed_bf16_projections": dict(SPEED, de=48),
    "speed_f32": dict(SPEED, compute_dtype="float32"),
    "pallas_f32": dict(pallas=True),
    "fast_external_vals": dict(pallas=True, fast=True, fused_topa=False),
    "candidate_low_rank": dict(pallas=True, fast=True, concat_rank=8),
    "candidate_K512": dict(pallas=True, K=512),
    "speed_approx_beam": dict(SPEED, approx_beam=True),
}
# The scoring wrapper each route must call on every MLP step.
ROUTE = {
    "pallas_f32": "selected_scores",
    "fast_external_vals": "selected_scores",
    "candidate_low_rank": "candidate_scores",
    "candidate_K512": "candidate_scores",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_route_matches_jax(monkeypatch, name):
    js, ts, jp, tp, _ = make_models(seed=31, **CASES[name])
    x = data(64, js.D, seed=32)
    scorer = ROUTE.get(name, "fused_substep_scores")
    calls = []
    wrapped = getattr(kernels, scorer)
    monkeypatch.setattr(kernels, scorer, lambda *a, **k: calls.append(1) or wrapped(*a, **k))

    cj, xj, _ = jq.encode(jp, js, jnp.asarray(x))
    ct, xt, _ = tq.encode(tp, ts, torch.from_numpy(x))
    assert len(calls) == ts.n_mlp_steps
    cj, ct = np.asarray(cj), ct.numpy()
    assert ct.shape == (ts.M_ivf, len(x))
    assert (ct == cj).mean() >= (0.95 if js.compute_dtype == "bfloat16" else 0.99)
    mj, mt = mse(x, xj), mse(x, xt.numpy())
    assert abs(mt - mj) <= 0.01 * mj, (mt, mj)
    # the encode reconstruction is the decode of the codes
    dec = tq.decode(tp, ts, torch.from_numpy(ct)).numpy()
    np.testing.assert_allclose(xt.numpy(), dec, rtol=1e-5, atol=1e-5)


def test_speed_encode_matches_jax_with_strict_rounding(tmp_path):
    js, ts, _, tp, leaves = make_models(seed=31, **CASES["speed_bf16_ivf"])
    x = data(64, js.D, seed=32)
    cj, xj, _ = jax_strict_bf16(js, leaves, x, np.zeros((js.M_ivf, 1), np.int32), tmp_path)
    ct, xt, _ = tq.encode(tp, ts, torch.from_numpy(x))
    ct, xt = ct.numpy(), xt.numpy()
    assert (ct == cj).mean() >= 0.99
    rows = (ct == cj).all(0)
    np.testing.assert_allclose(xt[rows], xj[rows], rtol=1e-5, atol=1e-5)


def test_perbin_has_no_effect_on_the_port():
    """perbin selects a TPU layout of the same function: the port's speed
    encode gives the same codes with it off."""
    _, ts, _, tp, _ = make_models(seed=33, **SPEED)
    x = torch.from_numpy(data(48, ts.D, seed=34))
    c1, x1, _ = tq.encode(tp, ts, x)
    c2, x2, _ = tq.encode(tp, ts.with_(perbin=False), x)
    assert torch.equal(c1, c2) and torch.equal(x1, x2)


def _speed_vs_exact_mse(noise):
    """The speed profile's MSE over the exact profile's on chip_smoke.py's
    random model and data (decodes of random codes plus ``noise``), at
    D=32 with qinco2-S's K, A, B and M."""
    import chip_smoke

    spec = QincoSpec(D=32, K=256, M=8, L=2, de=32, dh=64, A=16, B=32, **SPEED)
    params = chip_smoke.random_model(spec, 0, torch.device("cpu"))
    x = torch.from_numpy(chip_smoke.synthetic_data(spec, params, 128, 0, noise))
    x_n = (x - params.data_mean) / params.data_std
    exact = spec.with_(pallas=False, fast=False, compute_dtype="float32")
    mse_of = lambda s: float(((x - tq.decode_raw(params, s, tq.encode(params, s, x_n)[0])) ** 2)
                             .sum(-1).mean())
    return mse_of(spec) / mse_of(exact)


def test_speed_mse_on_the_smoke_data_depends_on_its_noise():
    """At the smoke's speed-path noise (0.5) the binned selection stays
    within the smoke's 1.05x bound; at its other paths' noise (0.05) each
    vector sits at the noise floor of its exact code and the same selection
    loses far more."""
    import chip_smoke

    at_smoke = _speed_vs_exact_mse(chip_smoke.SPEED_NOISE)
    at_floor = _speed_vs_exact_mse(chip_smoke.NOISE)
    assert at_smoke <= 1.05, at_smoke
    assert at_floor > 1.05, at_floor
