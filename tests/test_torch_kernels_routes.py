"""The plain versions of the port's speed-profile, external-vals and
candidate kernels, and select-rebuild with a low-rank concat factor,
against the JAX package's Pallas kernels (run with ``interpret=True`` on
the CPU), same inputs.  Tolerances as in tests/test_torch_kernels.py:
ids agree on >= 99.5% of slots at f32 and >= 98% at bf16; where they
agree the unpacked distances are within rtol 1e-4 at f32 and 1e-2 at
bf16.

- ``fused_substep_scores_plain`` against ``fused_substep_scores_pallas``
  for each table layout (fold_up in the per-bin and the blocked form,
  folded W1, low rank), plus an independent binned argmin of the ids.
- ``selected_scores_plain(vals=...)`` against ``selected_scores_pallas``
  with external ``vals``: the lean table (``fast``) and the folded one.
- ``candidate_scores_plain`` against ``candidate_scores_pallas``: packed
  ids with a low-rank concat factor, unpacked at K = 512.
- ``select_rebuild_plain`` against ``select_rebuild_pallas`` with a
  low-rank concat factor: codes and parents bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import data, make_models

from qinco_torch.ops import kernels
from qinco_tpu.ops import pallas_kernels as pk

# (spec fields, F_in, n_codes): a normal step, one with in/out
# projections, and the IVF first step (F_in = 1, n_codes = max(B, A)).
STEPS = {
    "step": (dict(), 8, 8),
    "step_projections": (dict(de=48), 8, 8),
    "ivf_first": (dict(ivf_K=64, B=16), 1, 16),
}
# The fused table's layouts (fused_substep_scores_pallas :521-561).
LAYOUTS = {
    "fold_up_perbin": dict(perbin=True),
    "fold_up_blocked": dict(perbin=False),
    "folded_w1": dict(fold_up=False),
    "low_rank": dict(concat_rank=8),
}
N = 24


def _unpacked(v):
    return (np.ascontiguousarray(v).view(np.int32) & ~0xFF).view(np.float32)


def _ids(v):
    return np.ascontiguousarray(v).view(np.int32) & 0xFF


def _inputs(step, dtype, seed, **kw):
    fields, F_in, n_codes = STEPS[step]
    js, ts, jp, tp, _ = make_models(seed=seed, compute_dtype=dtype, pallas=True,
                                    **{**fields, **kw})
    x = data(N, js.D, seed=seed + 1)
    xh = np.repeat(x, F_in, 0) + data(N * F_in, js.D, seed=seed + 2, scale=0.7)
    return js, ts, jax.tree.map(lambda a: a[0], jp.steps), tp.step(0), x, xh, F_in, n_codes


def _assert_scores_match(got, want, dtype):
    assert got.shape == want.shape
    same = _ids(got) == _ids(want)
    assert same.mean() >= (0.995 if dtype == "float32" else 0.98)
    np.testing.assert_allclose(_unpacked(got)[same], _unpacked(want)[same],
                               rtol=1e-4 if dtype == "float32" else 1e-2, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fused_substep_plain_matches_pallas(layout, step, dtype):
    js, ts, jp0, tp0, x, xh, F_in, n_codes = _inputs(step, dtype, seed=21, fast=True,
                                                     fused_substep=True, **LAYOUTS[layout])
    want = np.array(pk.fused_substep_scores_pallas(
        js, jnp.asarray(np.repeat(x, F_in, 0)), jnp.asarray(xh), jp0.sub_codebook,
        jp0.codebook, jp0.in_proj, jp0.concat_w, jp0.concat_w2, jp0.concat_b, jp0.ffn_up,
        jp0.ffn_down, jp0.out_proj, n_codes=n_codes, row_tile=64, interpret=True))
    xt, xht = torch.from_numpy(x), torch.from_numpy(xh)
    got = kernels.fused_substep_scores_plain(ts, xt, xht, tp0, n_codes).numpy()
    assert got.shape == (N * F_in, n_codes)
    _assert_scores_match(got, want, dtype)

    # The ids are the binned argmin of the packed substep distances over
    # the same rounded operands: slot a holds the best codeword of bin a.
    rnd = kernels.rounder(ts)
    C = tp0.sub_codebook.double()
    r = (xt.repeat_interleave(F_in, 0) - xht)
    d = (C * C).sum(1) - 2.0 * (rnd(r).double() @ rnd(tp0.sub_codebook).double().T)
    d_p = kernels.pack_ids_f32(d.float(), torch.arange(ts.K)[None, :]).numpy()
    G = ts.K // n_codes
    exp = np.stack([d_p[:, a * G:(a + 1) * G].argmin(1) + a * G for a in range(n_codes)], 1)
    assert (_ids(got) == exp).mean() >= 0.99

    # the wrapper takes the plain version for CPU tensors, and counts no launch
    before = dict(kernels.LAUNCHES)
    wrapped = kernels.fused_substep_scores(ts, xt, xht, tp0, n_codes).numpy()
    assert (wrapped.view(np.int32) == got.view(np.int32)).all()
    assert kernels.LAUNCHES == before


def _external_vals(ts, tp0, x, xh, F_in, n_codes):
    """The packed exact top-A of the f32 substep distances, (NF, A)."""
    r = torch.from_numpy(np.repeat(x, F_in, 0) - xh)
    sub = tp0.sub_codebook
    d = (sub * sub).sum(1) - 2.0 * (r @ sub.T)
    packed = kernels.pack_ids_f32(d, torch.arange(ts.K)[None, :])
    return torch.sort(packed, dim=1, stable=True).values[:, :n_codes].contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", ["step", "step_projections"])
@pytest.mark.parametrize("table", ["lean", "folded"])
def test_selected_scores_external_vals_matches_pallas(table, step, dtype):
    js, ts, jp0, tp0, x, xh, F_in, n_codes = _inputs(step, dtype, seed=23,
                                                     fast=table == "lean")
    vals = _external_vals(ts, tp0, x, xh, F_in, n_codes)
    want = np.array(pk.selected_scores_pallas(
        js, jnp.asarray(np.repeat(x, F_in, 0)), jnp.asarray(xh), jnp.asarray(vals.numpy().T),
        jp0.codebook, jp0.in_proj, jp0.concat_w, jp0.concat_b, jp0.ffn_up, jp0.ffn_down,
        jp0.out_proj, n_codes=n_codes, row_tile=64, interpret=True))
    xt, xht = torch.from_numpy(x), torch.from_numpy(xh)
    got = kernels.selected_scores_plain(ts, xt, xht, tp0, n_codes, vals=vals).numpy()
    _assert_scores_match(got, want, dtype)
    # the slots keep the external ids, in their order
    assert (_ids(got) == kernels.unpack_ids(vals).numpy()).all()
    wrapped = kernels.selected_scores(ts, xt, xht, tp0, n_codes, vals=vals).numpy()
    assert (wrapped.view(np.int32) == got.view(np.int32)).all()


CANDIDATES = {
    "packed_low_rank": dict(concat_rank=8),
    "unpacked_K512": dict(K=512),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CANDIDATES))
def test_candidate_scores_plain_matches_pallas(case, dtype):
    js, ts, jp0, tp0, x, xh, F_in, n_codes = _inputs("step_projections", dtype, seed=25,
                                                     fast=True, **CANDIDATES[case])
    pack = ts.K <= 256
    idx = np.random.default_rng(26).integers(0, ts.K, (N * F_in, n_codes)).astype(np.int32)
    x_f = np.repeat(x, F_in, 0)
    want = np.array(pk.candidate_scores_pallas(
        js, jnp.asarray(x_f), jnp.asarray(xh), jnp.asarray(idx), jp0.codebook, jp0.in_proj,
        jp0.concat_w, jp0.concat_w2, jp0.concat_b, jp0.ffn_up, jp0.ffn_down, jp0.out_proj,
        row_tile=64, interpret=True, pack_ids=pack))
    args = (ts, torch.from_numpy(x_f), torch.from_numpy(xh), torch.from_numpy(idx), tp0)
    got = kernels.candidate_scores_plain(*args, pack_ids=pack).numpy()
    assert got.shape == want.shape == idx.shape
    rtol = 1e-4 if dtype == "float32" else 1e-2
    if pack:
        assert (_ids(got) == idx).all() and (_ids(want) == idx).all()
        np.testing.assert_allclose(_unpacked(got), _unpacked(want), rtol=rtol, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)
    wrapped = kernels.candidate_scores(*args, pack_ids=pack).numpy()
    assert (wrapped.view(np.int32) == got.view(np.int32)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", ["step", "step_projections"])
def test_select_rebuild_low_rank_matches_pallas(step, dtype):
    js, ts, jp0, tp0, x, xh, F_in, n_codes = _inputs(step, dtype, seed=27, fast=True,
                                                     concat_rank=8)
    idx = np.stack([np.random.default_rng(28 + i).permutation(ts.K)[:n_codes]
                    for i in range(N * F_in)]).astype(np.int32)
    dists = np.array(pk.candidate_scores_pallas(
        js, jnp.asarray(np.repeat(x, F_in, 0)), jnp.asarray(xh), jnp.asarray(idx),
        jp0.codebook, jp0.in_proj, jp0.concat_w, jp0.concat_w2, jp0.concat_b, jp0.ffn_up,
        jp0.ffn_down, jp0.out_proj, row_tile=64, interpret=True, pack_ids=True))
    dists = dists.reshape(N, F_in * n_codes)
    dists[:, n_codes:2 * n_codes] = dists[:, :n_codes]  # ties: beam 1 repeats beam 0
    F_out = js.B
    xj, cj, pj = (np.asarray(a) for a in pk.select_rebuild_pallas(
        js, jnp.asarray(dists), jnp.asarray(xh), jp0.codebook, jp0.in_proj, jp0.concat_w,
        jp0.concat_w2, jp0.concat_b, jp0.ffn_up, jp0.ffn_down, jp0.out_proj,
        A_eff=n_codes, F_out=F_out, vec_tile=8, interpret=True))
    xt, ct, pt = (a.numpy() for a in kernels.select_rebuild_plain(
        ts, torch.from_numpy(dists), torch.from_numpy(xh), tp0, n_codes, F_out))
    assert (ct == cj).all() and (pt == pj).all()
    if dtype == "float32":
        np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-5)
    else:  # XLA's CPU excess precision drops some bf16 rounding points (test_torch_kernels.py)
        err = np.abs(xt - xj)
        assert err.max() <= 0.1 and err.mean() <= 0.01, (err.max(), err.mean())
