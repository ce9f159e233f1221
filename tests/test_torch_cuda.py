"""The port's CUDA kernels against their plain PyTorch versions, on the card:
selected scores (in-kernel top-A and external vals, lean and folded
tables), select-rebuild (with and without a low-rank concat factor),
fused-substep scores (each table layout) and candidate scores (packed
with a low-rank factor, unpacked at K = 1024); and the bf16 tensor-core
kernels with a ragged last work item.  Under bf16 every kernel is its
tensor-core route.

Every case here needs a CUDA device and skips without one.  On a machine
with a card (JAX is not needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: at float32 the kernels and the plain versions differ only in
summation order (the plain products go through cuBLAS with TF32 off); the
rebuilt reconstructions get atol 1e-4 rather than 1e-5 because at the
qinco2-M widths each passes through six products of up to 512 terms.  At
bfloat16 a different summation order can flip a value that sits on a bf16
rounding point by one unit in the last place (2^-8 relative), and the
flip propagates through the rest of the MLP.  The scores' checks allow
that; the bf16 reconstructions of select-rebuild are held, with the
plain version's, against sums exact to float64 (``torch_exact``).
"""

import numpy as np
import pytest
import torch

from qinco_torch.models.params import init_params
from qinco_torch.models.spec import QincoSpec
from qinco_torch.ops import kernels
from torch_exact import assert_near_exact, rebuild_exact

# (widths, F_in, n_codes): a normal step, the IVF first step (F_in = 1,
# n_codes = max(B, A)), at small widths, with in/out projections, and at
# the qinco2-S, qinco2-M and qinco2-L widths.
CASES = {
    "small": (dict(D=32, K=64, L=2, de=32, dh=64, A=8, B=8), 8, 8),
    "small_proj": (dict(D=32, K=64, L=1, de=48, dh=64, A=8, B=8), 8, 8),
    "S": (dict(D=128, K=256, L=2, de=128, dh=256, A=16, B=32), 32, 16),
    "S_ivf_first": (dict(D=128, K=256, L=2, de=128, dh=256, A=16, B=32), 1, 32),
    "M": (dict(D=128, K=256, L=4, de=384, dh=384, A=16, B=32), 32, 16),
    "L": (dict(D=128, K=256, L=16, de=384, dh=384, A=16, B=32), 32, 16),
}
DTYPES = ("float32", "bfloat16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _step(widths, dtype, seed, device, **kw):
    """One step's weights, with the zero-initialized concat and FFN-down
    weights randomized (std 0.05) so that the MLP does something.  Past
    L = 4 blocks the std shrinks as 0.05 * 4 / L: each block multiplies the
    activations' scale by about 2 at 0.05, which at L = 16 would take them
    to 1e4 and the distances to 1e8, where the summation order of the f32
    products alone moves results past the tolerances below."""
    fields = dict(M=2, pallas=True, fast=True, fused_select=True, compute_dtype=dtype)
    spec = QincoSpec(**{**fields, **widths, **kw})
    g = torch.Generator().manual_seed(seed)
    p = init_params(spec, g, device="cpu").step(0)
    std = 0.05 * min(1.0, 4 / spec.L)
    p = p._replace(**{
        f: a + std * torch.randn(a.shape, generator=g)
        for f, a in p._asdict().items() if a is not None and not a.any()
    })
    return spec, p._replace(**{f: None if a is None else a.to(device)
                               for f, a in p._asdict().items()})


def _inputs(spec, F_in, N, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, spec.D), generator=g)
    xh = x.repeat_interleave(F_in, 0) + 0.7 * torch.randn((N * F_in, spec.D), generator=g)
    return x.to(device), xh.to(device)


def _unpacked(v):
    return (v.contiguous().view(torch.int32) & ~0xFF).view(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_selected_scores_kernel_matches_plain(cuda, case, dtype):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, dtype, seed=1, device=cuda)
    x, xh = _inputs(spec, F_in, N=70, seed=2, device=cuda)
    before = kernels.LAUNCHES["selected_scores"]
    got = kernels.selected_scores(spec, x, xh, p, n_codes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selected_scores"] == before + 1
    want = kernels.selected_scores_plain(spec, x, xh, p, n_codes)
    assert got.shape == want.shape == (xh.shape[0], n_codes)
    same = kernels.unpack_ids(got) == kernels.unpack_ids(want)
    assert same.float().mean() >= (0.995 if dtype == "float32" else 0.98)
    rtol = 1e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_unpacked(got)[same].cpu(), _unpacked(want)[same].cpu(),
                               rtol=rtol, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_select_rebuild_kernel_matches_plain(cuda, case, dtype):
    """Codes and parents bit-equal to the plain version's; the
    reconstructions at f32 within the summation order of 512-term sums,
    at bf16 no further from exact sums than the plain version's, up to
    ``torch_exact``'s multiples."""
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, dtype, seed=3, device=cuda)
    x, xh = _inputs(spec, F_in, N=70, seed=4, device=cuda)
    N = x.shape[0]
    dists = kernels.selected_scores_plain(spec, x, xh, p, n_codes).reshape(N, F_in * n_codes)
    if F_in > 1:  # ties: beam 1 repeats beam 0's packed values
        dists[:, n_codes:2 * n_codes] = dists[:, :n_codes]
    F_out = min(spec.B, F_in * n_codes)
    before = kernels.LAUNCHES["select_rebuild"]
    xhat, codes, parents = kernels.select_rebuild(spec, dists, xh, p, n_codes, F_out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["select_rebuild"] == before + 1
    xhat_p, codes_p, parents_p = kernels.select_rebuild_plain(spec, dists, xh, p, n_codes, F_out)
    assert torch.equal(codes, codes_p)
    assert torch.equal(parents, parents_p)
    if dtype == "float32":
        torch.testing.assert_close(xhat, xhat_p, rtol=1e-5, atol=1e-4)
    else:
        assert_near_exact(xhat, xhat_p, rebuild_exact(spec, p, xh, codes_p, parents_p))


def _check_scores(got, want, dtype):
    assert got.shape == want.shape
    same = kernels.unpack_ids(got) == kernels.unpack_ids(want)
    assert same.float().mean() >= (0.995 if dtype == "float32" else 0.98)
    rtol = 1e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_unpacked(got)[same].cpu(), _unpacked(want)[same].cpu(),
                               rtol=rtol, atol=1e-4)


# The fused-substep table layouts: fold_up (the speed default), W1 folded
# into the h slice (fold_up off), and the low-rank concat factor.
LAYOUTS = {"fold_up": {}, "folded_w1": dict(fold_up=False), "low_rank": dict(concat_rank=8)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fused_substep_kernel_matches_plain(cuda, layout, case, dtype):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, dtype, seed=5, device=cuda, fused_substep=True, **LAYOUTS[layout])
    x, xh = _inputs(spec, F_in, N=70, seed=6, device=cuda)
    before = kernels.LAUNCHES["fused_substep_scores"]
    got = kernels.fused_substep_scores(spec, x, xh, p, n_codes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_substep_scores"] == before + 1
    _check_scores(got, kernels.fused_substep_scores_plain(spec, x, xh, p, n_codes), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("table", ["lean", "folded"])
def test_selected_scores_external_vals_kernel_matches_plain(cuda, table, case, dtype):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, dtype, seed=7, device=cuda, fast=table == "lean")
    x, xh = _inputs(spec, F_in, N=70, seed=8, device=cuda)
    r = x.repeat_interleave(F_in, 0) - xh
    sub = p.sub_codebook
    ids = torch.arange(spec.K, device=cuda)[None, :]
    packed = kernels.pack_ids_f32((sub * sub).sum(1) - 2.0 * (r @ sub.T), ids)
    vals = torch.sort(packed, dim=1, stable=True).values[:, :n_codes].contiguous()
    before = kernels.LAUNCHES["selected_scores"]
    got = kernels.selected_scores(spec, x, xh, p, n_codes, vals=vals)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selected_scores"] == before + 1
    want = kernels.selected_scores_plain(spec, x, xh, p, n_codes, vals=vals)
    assert torch.equal(kernels.unpack_ids(got), kernels.unpack_ids(vals))
    _check_scores(got, want, dtype)


# Candidate scores: packed ids with a low-rank concat factor, and K = 1024
# (no packed ids).
CANDIDATES = {"packed_low_rank": dict(concat_rank=8), "unpacked_K1024": dict(K=1024)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", sorted(CANDIDATES))
def test_candidate_scores_kernel_matches_plain(cuda, kind, case, dtype):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, dtype, seed=9, device=cuda, **CANDIDATES[kind])
    x, xh = _inputs(spec, F_in, N=70, seed=10, device=cuda)
    x_f = x.repeat_interleave(F_in, 0)
    g = torch.Generator().manual_seed(11)
    idx = torch.randint(0, spec.K, xh.shape[:1] + (n_codes,), generator=g).int().to(cuda)
    pack = spec.K <= 256
    before = kernels.LAUNCHES["candidate_scores"]
    got = kernels.candidate_scores(spec, x_f, xh, idx, p, pack_ids=pack)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["candidate_scores"] == before + 1
    want = kernels.candidate_scores_plain(spec, x_f, xh, idx, p, pack_ids=pack)
    if pack:
        assert torch.equal(kernels.unpack_ids(got), idx)
        got, want = _unpacked(got), _unpacked(want)
    rtol = 1e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=rtol, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_select_rebuild_low_rank_kernel_matches_plain(cuda, case, dtype):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, dtype, seed=12, device=cuda, concat_rank=8)
    x, xh = _inputs(spec, F_in, N=70, seed=13, device=cuda)
    N = x.shape[0]
    g = torch.Generator().manual_seed(14)
    idx = torch.randint(0, spec.K, xh.shape[:1] + (n_codes,), generator=g).int().to(cuda)
    dists = kernels.candidate_scores_plain(spec, x.repeat_interleave(F_in, 0), xh, idx, p,
                                           pack_ids=True).reshape(N, F_in * n_codes)
    if F_in > 1:  # ties: beam 1 repeats beam 0's packed values
        dists[:, n_codes:2 * n_codes] = dists[:, :n_codes]
    F_out = min(spec.B, F_in * n_codes)
    xhat, codes, parents = kernels.select_rebuild(spec, dists, xh, p, n_codes, F_out)
    torch.cuda.synchronize()
    xhat_p, codes_p, parents_p = kernels.select_rebuild_plain(spec, dists, xh, p, n_codes, F_out)
    assert torch.equal(codes, codes_p)
    assert torch.equal(parents, parents_p)
    if dtype == "float32":
        torch.testing.assert_close(xhat, xhat_p, rtol=1e-5, atol=1e-4)
    else:
        assert_near_exact(xhat, xhat_p, rebuild_exact(spec, p, xh, codes_p, parents_p))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["S", "S_ivf_first", "M"])
def test_bf16_kernels_ragged_last_work_item(cuda, case):
    """N = 1029 vectors: select-rebuild's last work item (4 vectors at
    qinco2-S, 2 at qinco2-M) holds 1 and leaves most of its tile empty, and
    so does selected scores' at the IVF first step (4 beam rows an item);
    both against their plain versions: scores as above, codes and parents
    bit-equal, xhat within rtol 1e-2 of the output's scale.  (A bf16
    rounding point that two summation orders resolve differently moves a
    value by one bf16 unit, 2^-8 relative, and the MLP carries it on; at
    |xhat| up to 40 that is more than the 5e-2 of the checks above.)"""
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "bfloat16", seed=15, device=cuda)
    x, xh = _inputs(spec, F_in, N=1029, seed=16, device=cuda)
    N = x.shape[0]
    _check_scores(kernels.selected_scores(spec, x, xh, p, n_codes),
                  kernels.selected_scores_plain(spec, x, xh, p, n_codes), "bfloat16")
    dists = kernels.selected_scores_plain(spec, x, xh, p, n_codes).reshape(N, F_in * n_codes)
    F_out = min(spec.B, F_in * n_codes)
    xhat, codes, parents = kernels.select_rebuild(spec, dists, xh, p, n_codes, F_out)
    torch.cuda.synchronize()
    xhat_p, codes_p, parents_p = kernels.select_rebuild_plain(spec, dists, xh, p, n_codes, F_out)
    assert torch.equal(codes, codes_p)
    assert torch.equal(parents, parents_p)
    scale = xhat_p.abs().max().item()
    torch.testing.assert_close(xhat, xhat_p, rtol=1e-2, atol=1e-2 * scale)


# The ragged cases of the bf16 scoring kernels: N = 1029 vectors.  At the
# IVF first step (F_in = 1, 4 beam rows an item) the last work item holds 1
# row, 32 of its 128 pairs (and at the qinco2-M widths one 64-pair tile of
# two, the other empty); at a normal step the rows fill their items.
RAGGED = ["S", "S_ivf_first", "M"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bf16_fused_substep_ragged_last_work_item(cuda, layout, case):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "bfloat16", seed=17, device=cuda, fused_substep=True,
                    **LAYOUTS[layout])
    x, xh = _inputs(spec, F_in, N=1029, seed=18, device=cuda)
    got = kernels.fused_substep_scores(spec, x, xh, p, n_codes)
    torch.cuda.synchronize()
    _check_scores(got, kernels.fused_substep_scores_plain(spec, x, xh, p, n_codes), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("kind", sorted(CANDIDATES))
def test_bf16_candidate_ragged_last_work_item(cuda, kind, case):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "bfloat16", seed=19, device=cuda, **CANDIDATES[kind])
    x, xh = _inputs(spec, F_in, N=1029, seed=20, device=cuda)
    x_f = x.repeat_interleave(F_in, 0)
    g = torch.Generator().manual_seed(21)
    idx = torch.randint(0, spec.K, xh.shape[:1] + (n_codes,), generator=g).int().to(cuda)
    pack = spec.K <= 256
    got = kernels.candidate_scores(spec, x_f, xh, idx, p, pack_ids=pack)
    torch.cuda.synchronize()
    want = kernels.candidate_scores_plain(spec, x_f, xh, idx, p, pack_ids=pack)
    if pack:
        assert torch.equal(kernels.unpack_ids(got), idx)
        got, want = _unpacked(got), _unpacked(want)
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-2, atol=1e-4)
