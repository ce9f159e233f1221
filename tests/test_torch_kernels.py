"""The plain versions of the port's kernels against the JAX package's
Pallas kernels (run with ``interpret=True`` on the CPU), same inputs.

- ``pack_ids_f32`` is bit-equal to ``_pack_ids_f32``.
- ``selected_scores_plain`` against ``selected_scores_pallas`` with
  ``sub_codebook`` (the in-kernel exact top-A): ids agree on >= 99.5% of
  slots at f32 and >= 98% at bf16; where they agree the unpacked
  distances are within rtol 1e-4 at f32 and 1e-2 at bf16 (the tolerance
  of tests/test_fast_profile.py).
- ``select_rebuild_plain`` against ``select_rebuild_pallas`` fed the same
  packed distances: codes and parents bit-equal, ties included; xhat
  within rtol 1e-5 at f32.  At bf16, XLA's CPU default of excess
  precision drops some bf16 rounding points on the JAX side (see
  tests/test_torch_decode.py), so xhat gets max |diff| <= 0.1 and mean
  |diff| <= 0.01.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import data, make_models

from qinco_torch.ops import kernels
from qinco_tpu.ops import pallas_kernels as pk

# (spec fields, F_in, n_codes): a normal step and the IVF first step
# (F_in = 1, n_codes = max(B, A)), with and without in/out projections.
STEPS = {
    "step": (dict(), 8, 8),
    "step_projections": (dict(de=48), 8, 8),
    "ivf_first": (dict(ivf_K=64, B=16), 1, 16),
}
N = 24


def _unpacked(v):
    return (np.ascontiguousarray(v).view(np.int32) & ~0xFF).view(np.float32)


def _ids(v):
    return np.ascontiguousarray(v).view(np.int32) & 0xFF


def test_pack_ids_bit_equal():
    tiny = np.float32(1e-30)
    special = np.array(
        [0.0, -0.0, 1e-31, -1e-31, 1e-30, -1e-30, tiny * 0.999, 1e-40, -1e-42, 1e-45,
         -3.5, 2.0, 1e38, -1e38, 1.17549435e-38, np.inf, -np.inf], np.float32)
    rng = np.random.default_rng(0)
    d = np.concatenate([special, rng.standard_normal(200).astype(np.float32) * 10,
                        (rng.standard_normal(50) * 1e-35).astype(np.float32)])
    ids = rng.integers(0, 256, d.shape).astype(np.int32)
    want = np.asarray(pk._pack_ids_f32(jnp.asarray(d), jnp.asarray(ids)))
    got = kernels.pack_ids_f32(torch.from_numpy(d), torch.from_numpy(ids)).numpy()
    assert (got.view(np.int32) == want.view(np.int32)).all()
    assert (kernels.unpack_ids(torch.from_numpy(got)).numpy() == ids).all()


def _step_inputs(name, dtype, seed):
    fields, F_in, n_codes = STEPS[name]
    js, ts, jp, tp, _ = make_models(seed=seed, compute_dtype=dtype, pallas=True, fast=True,
                                    fused_select=True, **fields)
    x = data(N, js.D, seed=seed + 1)
    xh = np.repeat(x, F_in, 0) + data(N * F_in, js.D, seed=seed + 2, scale=0.7)
    return js, ts, jax.tree.map(lambda a: a[0], jp.steps), tp.step(0), x, xh, F_in, n_codes


def _jax_selected(js, jp0, x, xh, F_in, n_codes):
    return np.array(pk.selected_scores_pallas(
        js, jnp.asarray(np.repeat(x, F_in, 0)), jnp.asarray(xh), None, jp0.codebook,
        jp0.in_proj, jp0.concat_w, jp0.concat_b, jp0.ffn_up, jp0.ffn_down, jp0.out_proj,
        n_codes=n_codes, row_tile=64, interpret=True, sub_codebook=jp0.sub_codebook))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(STEPS))
def test_selected_scores_plain_matches_pallas(name, dtype):
    js, ts, jp0, tp0, x, xh, F_in, n_codes = _step_inputs(name, dtype, seed=3)
    want = _jax_selected(js, jp0, x, xh, F_in, n_codes)
    got = kernels.selected_scores_plain(ts, torch.from_numpy(x), torch.from_numpy(xh), tp0,
                                        n_codes).numpy()
    assert got.shape == want.shape == (N * F_in, n_codes)
    same = _ids(got) == _ids(want)
    assert same.mean() >= (0.995 if dtype == "float32" else 0.98)
    np.testing.assert_allclose(_unpacked(got)[same], _unpacked(want)[same],
                               rtol=1e-4 if dtype == "float32" else 1e-2, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors, and counts no launch
    before = dict(kernels.LAUNCHES)
    wrapped = kernels.selected_scores(ts, torch.from_numpy(x), torch.from_numpy(xh), tp0,
                                      n_codes).numpy()
    assert (wrapped.view(np.int32) == got.view(np.int32)).all()
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(STEPS))
def test_select_rebuild_plain_matches_pallas(name, dtype):
    js, ts, jp0, tp0, x, xh, F_in, n_codes = _step_inputs(name, dtype, seed=5)
    dists = _jax_selected(js, jp0, x, xh, F_in, n_codes).reshape(N, F_in * n_codes)
    if F_in > 1:  # ties: beam 1 repeats beam 0's packed values
        dists[:, n_codes:2 * n_codes] = dists[:, :n_codes]
    F_out = min(js.B, F_in * n_codes)
    xj, cj, pj = (np.asarray(a) for a in pk.select_rebuild_pallas(
        js, jnp.asarray(dists), jnp.asarray(xh), jp0.codebook, jp0.in_proj, jp0.concat_w,
        jp0.concat_w2, jp0.concat_b, jp0.ffn_up, jp0.ffn_down, jp0.out_proj,
        A_eff=n_codes, F_out=F_out, vec_tile=8, interpret=True))
    xt, ct, pt = (a.numpy() for a in kernels.select_rebuild_plain(
        ts, torch.from_numpy(dists), torch.from_numpy(xh), tp0, n_codes, F_out))
    assert ct.dtype == pt.dtype == np.int32
    assert (ct == cj).all() and (pt == pj).all()
    assert xt.shape == xj.shape == (N, F_out, js.D)
    if dtype == "float32":
        np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(xt - xj)
        assert err.max() <= 0.1 and err.mean() <= 0.01, (err.max(), err.mean())


def test_kernels_refuse_what_they_do_not_take():
    _, ts, _, tp0, x, xh, F_in, _ = _step_inputs("step", "float32", seed=7)
    x, xh = torch.from_numpy(x), torch.from_numpy(xh)
    with pytest.raises(ValueError, match="n_codes <= K"):
        kernels.selected_scores(ts, x, xh, tp0, ts.K + 1)
    with pytest.raises(ValueError, match="F_out"):
        kernels.select_rebuild(ts, torch.zeros((N, F_in * 4)), xh, tp0, 4, F_in * 4 + 1)
    with pytest.raises(ValueError):  # x rows do not divide xh rows
        kernels.selected_scores(ts, x[:5], xh, tp0, 4)
    with pytest.raises(ValueError, match="A | K"):  # binned argmin: A must divide K
        kernels.fused_substep_scores(ts, x, xh, tp0, 3)
    with pytest.raises(ValueError, match="K <= 256"):  # no packed ids past K = 256
        kernels.candidate_scores(ts, xh, xh, torch.zeros((xh.shape[0], 4), dtype=torch.int32),
                                 tp0._replace(codebook=torch.zeros((512, ts.D))), pack_ids=True)
