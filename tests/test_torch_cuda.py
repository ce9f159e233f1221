"""The port's CUDA kernels against their plain PyTorch versions, on the card:
selected scores (in-kernel top-A and external vals, lean and folded
tables), select-rebuild (with and without a low-rank concat factor),
fused-substep scores (each table layout) and candidate scores (packed
with a low-rank factor, unpacked at K = 1024); the phase-breakdown
kernels of B2 and B4 (ops/breakdown.py, each mode or cut, selcat and the
streaming probes); the bf16 tensor-core
kernels and the f32 kernels of all four with a ragged last work item, and
the f32 kernels' repeatability; B2 on 128-pair tiles with the FFN hidden
in registers at the qinco2-M and -L widths, and B2 and B3 at D = 768,
where their plans take D in column passes, against their plain versions
and exact sums.  Under bf16
every kernel is its tensor-core route.  Then the determinism of the
segment sum, k-means and train steps on the card (same bits on every
run), and the search pipeline's device ops (the coarse probe, the
pairwise decoder) against the CPU.

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
from qinco_torch.ops import breakdown, kernels
from torch_exact import assert_near_exact, rebuild_exact, selected_exact

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


# B2 at bf16 where the work items are ragged: NF = 1001 beam rows at the
# IVF first step's F_in = 1, A = 32 (4 rows an item, 251 items: the last
# item holds one row, and the last cluster of two has a block past the
# last item), at the qinco2-S and qinco2-L widths, both routes.
B2_RAGGED = {"S": CASES["S"][0], "L": CASES["L"][0]}


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["topa", "vals"])
@pytest.mark.parametrize("case", sorted(B2_RAGGED))
def test_selected_scores_ragged_items_and_clusters(cuda, case, route):
    spec, p = _step(B2_RAGGED[case], "bfloat16", seed=11, device=cuda)
    x, xh = _inputs(spec, 1, N=1001, seed=12, device=cuda)
    plan = kernels.selected_launch_plan(spec, xh, kernels.selected_weights(spec, p), 32,
                                         route == "topa")
    assert xh.shape[0] % plan.per_item and plan.items % plan.cluster
    vals = _external_vals(spec, p, x, xh, 1, 32) if route == "vals" else None
    got = kernels.selected_scores(spec, x, xh, p, 32, vals=vals)
    torch.cuda.synchronize()
    want = kernels.selected_scores_plain(spec, x, xh, p, 32, vals=vals)
    _check_scores(got, want, "bfloat16")


@pytest.mark.cuda
def test_selected_scores_largest_plan_launches_clean(cuda):
    """B2 at the qinco2-L widths takes nearly all of a block's shared memory
    (232,448 B on sm_90) and clusters of blocks: the launch is accepted
    (the wrapper raises on a nonzero cudaGetLastError) and runs to the end
    without a fault."""
    spec, p = _step(CASES["L"][0], "bfloat16", seed=13, device=cuda)
    x, xh = _inputs(spec, 32, N=1024, seed=14, device=cuda)
    plan = kernels.selected_launch_plan(spec, xh, kernels.selected_weights(spec, p), 16, True)
    assert plan.smem > 224 * 1024 and plan.cluster > 1
    got = kernels.selected_scores(spec, x, xh, p, 16)
    torch.cuda.synchronize()
    assert torch.cuda.is_available() and got.isfinite().all()
    rows = slice(0, 512)  # the plain version on a stretch of the rows
    want = kernels.selected_scores_plain(spec, x[:16], xh[rows], p, 16)
    _check_scores(got[rows], want, "bfloat16")


# B2 at bf16 on 128-pair tiles, which hold the FFN hidden in registers, at
# the qinco2-M and -L widths (Dh = 384: 3 passes, 96 registers a thread):
# (N, F_in, A) of a normal step and of the IVF first step, where 1001 beam
# rows leave the last work item ragged.
REGS_CASES = ["M", "L"]
REGS_STEPS = {"step": (70, 32, 16), "ivf_first": (1001, 1, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("step", sorted(REGS_STEPS))
@pytest.mark.parametrize("route", ["topa", "vals"])
@pytest.mark.parametrize("case", REGS_CASES)
def test_selected_scores_register_hidden_matches_plain_and_exact(cuda, case, route, step):
    """Both routes through the register hidden: ids and scores as the plain
    version's (as above), one launch, and the scores of its candidates no
    further from sums exact to float64 than the plain version's, up to
    ``torch_exact``'s multiples."""
    N, F_in, A = REGS_STEPS[step]
    spec, p = _step(CASES[case][0], "bfloat16", seed=25, device=cuda)
    x, xh = _inputs(spec, F_in, N=N, seed=26, device=cuda)
    plan = kernels.selected_launch_plan(spec, xh, kernels.selected_weights(spec, p), A,
                                         route == "topa")
    assert (plan.tm, plan.d_passes) == (128, 1)
    assert step == "step" or xh.shape[0] % plan.per_item
    vals = _external_vals(spec, p, x, xh, F_in, A) if route == "vals" else None
    before = kernels.LAUNCHES["selected_scores"]
    got = kernels.selected_scores(spec, x, xh, p, A, vals=vals)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selected_scores"] == before + 1
    _check_scores(got, kernels.selected_scores_plain(spec, x, xh, p, A, vals=vals), "bfloat16")
    plain = kernels.selected_scores_plain(spec, x, xh, p, A, vals=got)  # the kernel's candidates
    exact = selected_exact(spec, x, xh, p, kernels.unpack_ids(got))
    assert_near_exact(_unpacked(got), _unpacked(plain), exact)


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


# The phase-breakdown kernels (ops/breakdown.py) at bf16, the lean fetch:
# B2's cuts at the small widths with projections and at the qinco2-S and
# -M widths, B4's at the small (with projections) and qinco2-S widths.
BREAKDOWN_CASES = ["small_proj", "S", "M"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BREAKDOWN_CASES)
@pytest.mark.parametrize("mode", kernels.KTOPA_MODES)
def test_ktopa_variant_kernel_matches_plain(cuda, mode, case):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "bfloat16", seed=1, device=cuda)
    x, xh = _inputs(spec, F_in, N=70, seed=2, device=cuda)
    key = f"ktopa_variant:{kernels.KTOPA_ALIASES.get(mode, mode)}"
    before = kernels.LAUNCHES[key]
    got = breakdown.ktopa_variant(spec, x, xh, p, n_codes, mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    want = breakdown.ktopa_variant_plain(spec, x, xh, p, n_codes, mode)
    if mode != "nodist":
        _check_scores(got, want, "bfloat16")
        return
    # |sum(out + cand)| + 1 with slot a's id a: a bf16 rounding flip of an
    # early block moves every term after it, which the signed sum does not
    # damp as the distance's squares do, and the kernel and the plain
    # version flip in their own places; so both are held against the sums
    # exact to float64 (chip_smoke.compare_nodist)
    assert torch.equal(kernels.unpack_ids(got), kernels.unpack_ids(want))
    assert_near_exact(_unpacked(got), _unpacked(want),
                      breakdown.nodist_exact(spec, x, xh, p, n_codes))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small_proj", "S"])
@pytest.mark.parametrize("cut", ["sel", "sel+fetch", "fetchb"])
def test_fused_cut_kernel_matches_plain(cuda, cut, case):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "bfloat16", seed=5, device=cuda, fused_substep=True)
    x, xh = _inputs(spec, F_in, N=70, seed=6, device=cuda)
    key = f"fused_cut:{kernels.FUSED_ALIASES.get(cut, cut)}"
    before = kernels.LAUNCHES[key]
    got = breakdown.fused_cut(spec, x, xh, p, n_codes, cut)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    want = breakdown.fused_cut_plain(spec, x, xh, p, n_codes, cut)
    sel = breakdown.fused_cut(spec, x, xh, p, n_codes, "sel")
    sel_p = breakdown.fused_cut_plain(spec, x, xh, p, n_codes, "sel")
    # the bin minima are f32 sums in another order: ids equal wherever the
    # bin's two least values are more than 1e-3 apart
    w = kernels.fused_weights(spec, p)
    packed = kernels._substep_packed(spec, x.repeat_interleave(F_in, 0) - xh, w.sub_t, w.cn2)
    two = _unpacked(packed).view(len(xh), n_codes, -1).sort(dim=2).values[..., :2]
    same = kernels.unpack_ids(sel) == kernels.unpack_ids(sel_p)
    assert bool(same[two[..., 1] - two[..., 0] > 1e-3].all())
    if cut == "sel":
        got, want = _unpacked(got), _unpacked(want)
    np.testing.assert_allclose(got[same].cpu(), want[same].cpu(),
                               rtol=1e-4 if cut == "sel" else 1e-2, atol=1e-4)


def _close_sums(got, want, mass):
    """Signed f32 sums in another order: within rtol 1e-4 of the value plus
    1e-5 of the sum of |terms| (chip_smoke.compare_sums)."""
    assert bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-5 * mass).all())


# kernel_variants.py's cuts on the stand-in chain need de == D: the small
# and qinco2-S widths
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "S"])
@pytest.mark.parametrize("cut", ["dsub", "mlponly", "fullopt"])
def test_fused_cut_variant_kernel_matches_plain(cuda, cut, case):
    """dsub's sums of packed values as _close_sums; fullopt at the bf16
    limits; mlponly (every slot of a row equal) held with its plain version
    against sums exact to float64 (breakdown.mlponly_exact)."""
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "bfloat16", seed=5, device=cuda, fused_substep=True)
    x, xh = _inputs(spec, F_in, N=70, seed=6, device=cuda)
    key = f"fused_cut:{cut}"
    before = kernels.LAUNCHES[key]
    got = breakdown.fused_cut(spec, x, xh, p, n_codes, cut)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    want = breakdown.fused_cut_plain(spec, x, xh, p, n_codes, cut)
    if cut == "dsub":
        w = kernels.fused_weights(spec, p)
        packed = kernels._substep_packed(spec, x.repeat_interleave(F_in, 0) - xh, w.sub_t, w.cn2)
        _close_sums(got, want, _unpacked(packed).abs().view(len(xh), n_codes, -1).sum(2))
    elif cut == "mlponly":
        assert bool((got == got[:, :1]).all())
        assert_near_exact(got, want, breakdown.mlponly_exact(spec, x, xh, p, n_codes))
    else:
        _check_scores(got, want, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small_proj", "S"])
def test_selcat_kernel_matches_plain(cuda, case):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "bfloat16", seed=1, device=cuda)
    x, xh = _inputs(spec, F_in, N=70, seed=2, device=cuda)
    vals = _external_vals(spec, p, x, xh, F_in, n_codes)
    before = kernels.LAUNCHES["selcat"]
    got = breakdown.selcat(spec, x, xh, p, vals)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selcat"] == before + 1
    _check_scores(got, breakdown.selcat_plain(spec, x, xh, p, vals), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [100, 512])
@pytest.mark.parametrize("probe", ["noop", "bw_f32", "bw_bf16"])
def test_stream_probe_kernel_matches_plain(cuda, probe, rows):
    """noop bit for bit; bw's tile sums as _close_sums.  2240 rows: the
    last tile is ragged at both row counts."""
    _, xh = _inputs(QincoSpec(D=128, K=256, M=2, L=2, de=128, dh=256, A=16, B=32), 32, N=70,
                    seed=7, device=cuda)
    kind = probe.split("_")[0]
    data = xh.to(torch.bfloat16) if probe == "bw_bf16" else xh
    before = kernels.LAUNCHES[f"stream_probe:{probe}"]
    got = breakdown.stream_probe(data, kind, rows, 16)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[f"stream_probe:{probe}"] == before + 1
    want = breakdown.stream_probe_plain(data, kind, rows, 16)
    if kind == "noop":
        assert torch.equal(got, want)
    else:
        _close_sums(got, want, breakdown.stream_probe_plain(data.float().abs(), "bw", rows))


def _external_vals(spec, p, x, xh, F_in, n_codes):
    """The packed exact top-n_codes of the f32 substep distances."""
    r = x.repeat_interleave(F_in, 0) - xh
    sub = p.sub_codebook
    ids = torch.arange(spec.K, device=x.device)[None, :]
    packed = kernels.pack_ids_f32((sub * sub).sum(1) - 2.0 * (r @ sub.T), ids)
    return torch.sort(packed, dim=1, stable=True).values[:, :n_codes].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("table", ["lean", "folded"])
def test_selected_scores_external_vals_kernel_matches_plain(cuda, table, case, dtype):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, dtype, seed=7, device=cuda, fast=table == "lean")
    x, xh = _inputs(spec, F_in, N=70, seed=8, device=cuda)
    vals = _external_vals(spec, p, x, xh, F_in, n_codes)
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


# The f32 routes of B2' and B5 (the register-tiled kernels) at N = 1029
# vectors, with the limits of the f32 cases above: at the IVF first step
# (4 rows an item) the last work item holds one row, 32 of its 128 pairs,
# so its second 64-pair tile is empty; at a normal step the rows fill
# their items.
F32_CANDIDATES = {**CANDIDATES, "packed_rank64": dict(concat_rank=64)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("route", ["in_kernel_top_a", "external_vals"])
def test_f32_selected_scores_ragged_last_work_item(cuda, route, case):
    widths, F_in, n_codes = CASES[case]
    external = route == "external_vals"
    spec, p = _step(widths, "float32", seed=22, device=cuda, fast=not external)
    x, xh = _inputs(spec, F_in, N=1029, seed=23, device=cuda)
    vals = _external_vals(spec, p, x, xh, F_in, n_codes) if external else None
    before = kernels.LAUNCHES["selected_scores"]
    got = kernels.selected_scores(spec, x, xh, p, n_codes, vals=vals)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selected_scores"] == before + 1
    _check_scores(got, kernels.selected_scores_plain(spec, x, xh, p, n_codes, vals=vals),
                  "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("kind", sorted(F32_CANDIDATES))
def test_f32_candidate_ragged_last_work_item(cuda, kind, case):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "float32", seed=24, device=cuda, **F32_CANDIDATES[kind])
    x, xh = _inputs(spec, F_in, N=1029, seed=25, device=cuda)
    x_f = x.repeat_interleave(F_in, 0)
    g = torch.Generator().manual_seed(26)
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
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-4, atol=1e-4)


# The f32 routes of B4 (each table layout) and B3 (with and without a
# low-rank concat factor) at N = 1029 vectors, with the limits of the f32
# cases above.  B4 holds 16 beam rows an item at qinco2-S (8 at qinco2-M),
# so the last item holds 4 (of 8 at qinco2-M), and at the IVF first step
# one row of 4; B3 holds 2 vectors an item at qinco2-S, so the last item
# holds one vector, 32 of its 64 pairs.
F32_REBUILDS = {"full": {}, "rank64": dict(concat_rank=64)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_f32_fused_substep_ragged_last_work_item(cuda, layout, case):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "float32", seed=31, device=cuda, fused_substep=True,
                    **LAYOUTS[layout])
    x, xh = _inputs(spec, F_in, N=1029, seed=32, device=cuda)
    before = kernels.LAUNCHES["fused_substep_scores"]
    got = kernels.fused_substep_scores(spec, x, xh, p, n_codes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_substep_scores"] == before + 1
    _check_scores(got, kernels.fused_substep_scores_plain(spec, x, xh, p, n_codes), "float32")


def _packed_dists(spec, p, x, xh, F_in, n_codes, seed):
    """Packed distances (N, F_in·n_codes) for select-rebuild: the scores of
    random ids (candidate scores' plain version, which takes a low-rank
    factor)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, spec.K, xh.shape[:1] + (n_codes,), generator=g).int().to(x.device)
    d = kernels.candidate_scores_plain(spec, x.repeat_interleave(F_in, 0), xh, idx, p,
                                       pack_ids=True)
    return d.reshape(x.shape[0], F_in * n_codes)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("kind", sorted(F32_REBUILDS))
def test_f32_select_rebuild_ragged_last_work_item(cuda, kind, case):
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "float32", seed=33, device=cuda, **F32_REBUILDS[kind])
    x, xh = _inputs(spec, F_in, N=1029, seed=34, device=cuda)
    dists = _packed_dists(spec, p, x, xh, F_in, n_codes, seed=35)
    F_out = min(spec.B, F_in * n_codes)
    before = kernels.LAUNCHES["select_rebuild"]
    xhat, codes, parents = kernels.select_rebuild(spec, dists, xh, p, n_codes, F_out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["select_rebuild"] == before + 1
    xhat_p, codes_p, parents_p = kernels.select_rebuild_plain(spec, dists, xh, p, n_codes, F_out)
    assert torch.equal(codes, codes_p)
    assert torch.equal(parents, parents_p)
    torch.testing.assert_close(xhat, xhat_p, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["S", "M"])
def test_f32_kernels_repeat_bit_for_bit(cuda, case):
    """The f32 kernels of B2' (both routes), B4 (fold_up), B3 and B5 sum
    each output in one fixed order: two launches on the same inputs give
    the same bits."""
    widths, F_in, n_codes = CASES[case]
    spec, p = _step(widths, "float32", seed=27, device=cuda)
    x, xh = _inputs(spec, F_in, N=300, seed=28, device=cuda)
    vals = _external_vals(spec, p, x, xh, F_in, n_codes)
    for v in (None, vals):
        a = kernels.selected_scores(spec, x, xh, p, n_codes, vals=v)
        b = kernels.selected_scores(spec, x, xh, p, n_codes, vals=v)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    spec, p = _step(widths, "float32", seed=29, device=cuda, K=1024)
    idx = torch.randint(0, 1024, xh.shape[:1] + (n_codes,),
                        generator=torch.Generator().manual_seed(30)).int().to(cuda)
    x_f = x.repeat_interleave(F_in, 0)
    a = kernels.candidate_scores(spec, x_f, xh, idx, p)
    b = kernels.candidate_scores(spec, x_f, xh, idx, p)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    spec, p = _step(widths, "float32", seed=36, device=cuda, fused_substep=True)
    a = kernels.fused_substep_scores(spec, x, xh, p, n_codes)
    b = kernels.fused_substep_scores(spec, x, xh, p, n_codes)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    dists = _packed_dists(spec, p, x, xh, F_in, n_codes, seed=37)
    F_out = min(spec.B, F_in * n_codes)
    a = kernels.select_rebuild(spec, dists, xh, p, n_codes, F_out)
    b = kernels.select_rebuild(spec, dists, xh, p, n_codes, F_out)
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


@pytest.mark.cuda
def test_parity_train_step_on_the_card_matches_the_cpu(cuda):
    """One train step at the qinco2-S widths (M=4, 512 rows) under the
    parity profile: on the card its encode launches the selected-scores
    and select-rebuild kernels once per MLP step; on the CPU it runs their
    plain versions.  Codes agree on >= 99% of entries and the losses within
    rtol 1e-2; after the AdamW step each parameter leaf agrees within bf16
    tolerance (rtol 1e-2, atol 1e-5) on >= 98% of its elements and nowhere
    by more than the two learning rates that an Adam step whose gradient
    changed sign can move an element."""
    from qinco_torch.config import load_config
    from qinco_torch.models.params import QincoParams, StepParams, init_model_state
    from qinco_torch.models.params import param_leaves
    from qinco_torch.train import train_step as tts

    lr = 1e-3
    spec = QincoSpec(D=128, K=256, M=4, L=2, de=128, dh=256, A=16, B=32, pallas=True,
                     fast=True, fused_select=True, compute_dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    p = init_params(spec, g, device="cpu")
    steps = StepParams(*(a if a is None or a.any() else 0.05 * torch.randn(a.shape, generator=g)
                         for a in p.steps))
    p = QincoParams(p.codebook0, steps, p.data_mean, p.data_std)
    x = torch.randn((512, spec.D), generator=g)
    w = torch.ones(512)

    def run(device):
        params = QincoParams(*(
            StepParams(*(None if a is None else a.to(device).clone() for a in t))
            if isinstance(t, StepParams) else t.to(device).clone() for t in p))
        opt = tts.build_optimizer(load_config({"lr": lr}), params, spec)
        step = tts.make_train_step(spec, opt, 0.1)
        before = dict(kernels.LAUNCHES)
        params, mstate, out = step(params, init_model_state(spec, device=device), x.to(device),
                                   w.to(device))
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        return params, out, launched

    pc, outc, launched_c = run(torch.device("cpu"))
    pg, outg, launched_g = run(cuda)
    assert not any(launched_c.values())
    Ms = spec.n_mlp_steps
    assert launched_g == {k: Ms if k in ("selected_scores", "select_rebuild") else 0
                          for k in launched_g}
    assert (outg.codes.cpu() == outc.codes).float().mean() >= 0.99
    np.testing.assert_allclose(float(outg.total_loss), float(outc.total_loss), rtol=1e-2)
    for a, b in zip(param_leaves(pg), param_leaves(pc)):
        a, b = a.detach().cpu(), b.detach()
        off = (a - b).abs() > 1e-2 * b.abs() + 1e-5
        assert off.float().mean() <= 0.02
        assert (a - b).abs().max() <= 2.02 * lr + 1e-2 * b.abs().max()


# ---------------------------------------------------------------------------
# Run-to-run determinism on the card, and the search pipeline's device ops
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n, K", [(4096, 256), (65536, 65536), (1000, 1 << 20)])
def test_segment_sum_on_the_card_matches_the_cpu_and_repeats(cuda, n, K):
    """The card's segment sum equals the CPU's within f32 rounding (rtol
    1e-5, atol 1e-5) and gives the same bits on every run; ids skewed so
    that some segments are long."""
    from qinco_torch.ops.segment import segment_sum

    g = torch.Generator().manual_seed(0)
    x = torch.randn((n, 128), generator=g)
    ids = (torch.rand((n,), generator=g) ** 3 * K).long()
    want = segment_sum(x, ids, K)
    runs = [segment_sum(x.to(cuda), ids.to(cuda), K) for _ in range(3)]
    np.testing.assert_allclose(runs[0].cpu(), want, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


@pytest.mark.cuda
def test_kmeans_on_the_card_repeats_bit_for_bit(cuda):
    from qinco_torch.ops.kmeans import kmeans

    x = np.random.default_rng(0).standard_normal((1 << 16, 128)).astype(np.float32)
    a = kmeans(x, 4096, iters=3, seed=1, device=cuda)
    b = kmeans(x, 4096, iters=3, seed=1, device=cuda)
    np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_train_steps_on_the_card_repeat_bit_for_bit(cuda):
    """Three parity train steps from one seed, run twice: the losses and
    every parameter leaf are equal bit for bit (the gathers' gradients
    are segment sums, not atomic adds)."""
    from qinco_torch.config import load_config
    from qinco_torch.models.params import QincoParams, StepParams, init_model_state
    from qinco_torch.models.params import param_leaves
    from qinco_torch.train import train_step as tts

    spec = QincoSpec(D=128, K=256, M=8, L=2, de=128, dh=256, A=16, B=32, pallas=True,
                     fast=True, fused_select=True, compute_dtype="bfloat16")

    def run():
        g = torch.Generator(device=cuda).manual_seed(0)
        p = init_params(spec, g, device=cuda)
        steps = StepParams(*(a if a is None or a.any() else
                             0.05 * torch.randn(a.shape, generator=g, device=cuda)
                             for a in p.steps))
        p = QincoParams(p.codebook0, steps, p.data_mean, p.data_std)
        opt = tts.build_optimizer(load_config({"lr": 1e-3}), p, spec)
        step = tts.make_train_step(spec, opt, 0.1)
        mstate = init_model_state(spec, device=cuda)
        losses = []
        for _ in range(3):
            x = torch.randn((1024, spec.D), generator=g, device=cuda)
            p, mstate, out = step(p, mstate, x, torch.ones(1024, device=cuda))
            losses.append(out.total_loss.detach().clone())
        return [a.detach().clone() for a in param_leaves(p)], torch.stack(losses)

    (pa, la), (pb, lb) = run(), run()
    assert torch.equal(la, lb), (la, lb)
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_coarse_probe_on_the_card_matches_the_cpu(cuda):
    """The exact top-nprobe over a 2^16-centroid book: the card's lists
    equal the CPU's on >= 99.9% of entries (f32 products summed in
    another order may swap a near tie) and the biases agree where the
    lists do (rtol 1e-5)."""
    from qinco_torch.search.index import coarse_probe

    g = torch.Generator().manual_seed(0)
    cent = torch.randn((1 << 16, 128), generator=g)
    xq = cent[:512] + 0.3 * torch.randn((512, 128), generator=g)
    idx_c, d_c = coarse_probe(xq, cent, 64)
    idx_g, d_g = coarse_probe(xq.to(cuda), cent.to(cuda), 64)
    same = idx_g.cpu() == idx_c
    assert same.float().mean() >= 0.999
    np.testing.assert_allclose(d_g.cpu()[same], d_c[same], rtol=1e-5)


@pytest.mark.cuda
def test_pairwise_decoder_on_the_card_matches_the_native_library(cuda):
    """The decoder's torch path on the card against the native kernels of
    the CPU decoder: decodes within rtol 1e-5, atol 1e-5, scores within
    rtol 1e-4, atol 1e-4."""
    from qinco_torch.search.pairwise_decoder import PairwiseDecoder

    rng = np.random.default_rng(0)
    K_base, M_base, ivf_m, T, D, nlist = 16, 8, 5, 16, 128, 4096
    kw = dict(books=rng.normal(size=(T, K_base ** 2, D)).astype(np.float32),
              pairs=rng.integers(0, M_base + ivf_m, size=(2, T)),
              ivf_small_books=np.zeros((ivf_m, K_base, D), np.float32),
              ivf_code_map=rng.integers(0, K_base, size=(nlist, ivf_m)), K_base=K_base,
              M_base=M_base)
    gpu, cpu = PairwiseDecoder(**kw, device=cuda), PairwiseDecoder(**kw, device="cpu")
    nq, nmid = 64, 50
    codes = np.concatenate([rng.integers(0, nlist, size=(nq * nmid, 1)),
                            rng.integers(0, K_base, size=(nq * nmid, M_base))],
                           axis=1).astype(np.int32)
    np.testing.assert_allclose(gpu.decode(codes[:, 1:].T, codes[:, 0]),
                               cpu.decode(codes[:, 1:].T, codes[:, 0]), rtol=1e-5, atol=1e-5)
    xq = rng.normal(size=(nq, D)).astype(np.float32)
    cents = rng.normal(size=(nlist, D)).astype(np.float32)
    np.testing.assert_allclose(gpu.scores(xq, codes, cents, nmid),
                               cpu.scores(xq, codes, cents, nmid), rtol=1e-4, atol=1e-4)


def _params_to(p, device):
    """QINCo parameters ``p`` copied to ``device``."""
    from qinco_torch.models.params import QincoParams, StepParams

    steps = StepParams(*(None if a is None else a.to(device) for a in p.steps))
    return QincoParams(p.codebook0.to(device), steps, p.data_mean.to(device),
                       p.data_std.to(device))


@pytest.mark.cuda
def test_two_stage_search_on_the_card_matches_the_cpu(cuda):
    """The two-stage search at qinco2-S widths (f32) over 2^16 random codes:
    the card's ids equal the CPU's on >= 99.9% of entries (f32 products
    summed in another order may swap a near tie)."""
    from chip_smoke import random_model
    from qinco_torch.models.qinco import decode_raw
    from qinco_torch.search.two_stage import run_search_two_stage

    spec = QincoSpec(D=128, K=256, M=8, L=2, de=128, dh=256, A=16, B=32)
    params = random_model(spec, 0, "cpu")
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(0, spec.K, (spec.M, 1 << 16), generator=g, dtype=torch.int32)
    books = torch.randn((spec.M, spec.K, spec.D), generator=g)
    books *= 0.5 ** torch.arange(spec.M)[:, None, None]
    xq = decode_raw(params, spec, codes[:, :64]) + 0.01 * torch.randn((64, spec.D), generator=g)
    gt = np.arange(64)[:, None]
    args = (codes.numpy(), books.numpy(), xq.numpy(), gt)
    on_card = _params_to(params, cuda)
    I_cpu, r_cpu = run_search_two_stage(params, spec, *args, nshort=200, log=lambda *a: None)
    I_card, r_card = run_search_two_stage(on_card, spec, *args, nshort=200, log=lambda *a: None)
    assert I_card.shape == I_cpu.shape == (64, 100)
    assert (I_card == I_cpu).mean() >= 0.999
    assert all(abs(r_card[k] - r_cpu[k]) <= 1 / 64 for k in r_cpu)


@pytest.mark.cuda
def test_pq_encode_on_the_card_matches_the_cpu(cuda):
    """PQ-QINCo 2x16x8 with OPQ at D = 256 (the exact f32 profile, A = 0):
    codes on the card equal the CPU's on >= 99% of entries, and the rows
    whose codes all agree reconstruct within rtol 1e-5, atol 1e-4."""
    from qinco_torch.models.params import StepParams
    from qinco_torch.models.pq_qinco import init_pq_params, pq_encode

    sub = QincoSpec(D=128, K=256, M=16, L=2, de=128, dh=256, A=0, B=1)
    g = torch.Generator().manual_seed(0)
    opq, _ = torch.linalg.qr(torch.randn((256, 256), generator=g))
    p = init_pq_params(sub, 2, g, opq=opq.numpy(), device="cpu")
    fill = lambda a: a if a is None or a.any() else 0.05 * torch.randn(a.shape, generator=g)
    p = p._replace(parts=p.parts._replace(steps=StepParams(*(fill(a) for a in p.parts.steps))),
                   part_scales=torch.tensor([0.8, 1.2]))
    on_card = p._replace(parts=_params_to(p.parts, cuda), opq=p.opq.to(cuda),
                         part_scales=p.part_scales.to(cuda))
    x = 3.0 * torch.randn((64, 256), generator=g)
    c_cpu, x_cpu = pq_encode(p, sub, 2, x)
    c_card, x_card = pq_encode(on_card, sub, 2, x.to(cuda))
    same = c_card.cpu() == c_cpu
    assert same.float().mean() >= 0.99
    rows = same.all(0).all(0)
    np.testing.assert_allclose(x_card.cpu()[rows], x_cpu[rows], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_converted_checkpoint_encodes_as_its_source_on_the_card(cuda, tmp_path):
    """A qinco2-S model written as a reference ``.pt`` and read back by the
    ``.pt`` importer encodes 8,192 vectors under the parity profile to the
    same codes, bit for bit, as the model it came from."""
    from chip_smoke import NOISE, random_model, reference_state, spec_of, synthetic_data
    from qinco_torch.checkpoint import load_torch_checkpoint, params_from_torch_state
    from qinco_torch.models.params import init_model_state
    from qinco_torch.models.qinco import encode_chunked

    spec = spec_of("qinco2-S")
    params = random_model(spec, 1, cuda)
    torch.save({"model": reference_state(params, spec, init_model_state(spec, device=cuda))},
               str(tmp_path / "m.pt"))
    model_sd, _ = load_torch_checkpoint(tmp_path / "m.pt")
    back, _ = params_from_torch_state(model_sd, spec, device=cuda)
    x = synthetic_data(spec, params, 8192, 2, NOISE)
    np.testing.assert_array_equal(encode_chunked(back, spec, x, batch=1024),
                                  encode_chunked(params, spec, x, batch=1024))


# ---------------------------------------------------------------------------
# A one-rank NCCL process group (qinco_torch/parallel), in a subprocess
# ---------------------------------------------------------------------------

_ONE_RANK = r"""
import json, sys
import torch
from qinco_torch.config import load_config
from qinco_torch.models.params import (QincoParams, StepParams, init_model_state, init_params,
                                       param_leaves)
from qinco_torch.models.spec import QincoSpec
from qinco_torch.ops.distances import chunked_argmin_plain, sqdist_topk
from qinco_torch.parallel import distributed, mesh as pmesh
from qinco_torch.parallel.sharded_ops import shard_codebook, sharded_coarse_topk, sharded_ivf_assign
from qinco_torch.train import train_step as tts

torch.backends.cuda.matmul.allow_tf32 = False
assert distributed.maybe_init_distributed(cpu=False)
mesh = pmesh.make_mesh()
dev = torch.device("cuda", torch.cuda.current_device())
spec = QincoSpec(D=128, K=256, M=4, L=2, de=128, dh=256, A=16, B=32, pallas=True, fast=True,
                 fused_select=True, compute_dtype="bfloat16")
g = torch.Generator(device=dev).manual_seed(0)
p = init_params(spec, g, device=dev)
p = p._replace(steps=StepParams(*(a if a is None or a.any() else
                                  0.05 * torch.randn(a.shape, generator=g, device=dev)
                                  for a in p.steps)))
x = torch.randn((512, spec.D), generator=g, device=dev)
w = torch.ones(512, device=dev)
runs = []
for m in (None, mesh):
    q = QincoParams(*(StepParams(*(None if a is None else a.clone() for a in t))
                      if isinstance(t, StepParams) else t.clone() for t in p))
    step = tts.make_train_step(spec, tts.build_optimizer(load_config({"lr": 1e-3}), q, spec),
                               0.1, mesh=m)
    mstate = init_model_state(spec, device=dev)
    losses = []
    for _ in range(2):
        q, mstate, out = step(q, mstate, x, w)
        losses.append(out.total_loss.clone())
    runs.append(param_leaves(q) + list(mstate) + losses)
book = torch.randn((1 << 16, 128), generator=g, device=dev)
xq = book[:512] + 0.5 * torch.randn((512, 128), generator=g, device=dev)
ids, _ = sharded_coarse_topk(mesh, xq, shard_codebook(mesh, book), 64, exact=False)
ivf = sharded_ivf_assign(mesh, xq, shard_codebook(mesh, book))
json.dump(dict(world=mesh.world, grouped=mesh.grouped,
               step_equal=all(torch.equal(a, b) for a, b in zip(*runs)),
               topk_equal=torch.equal(ids, sqdist_topk(xq, book, 64)[0]),
               ivf_equal=torch.equal(ivf, chunked_argmin_plain(xq, book)[0])),
          open(sys.argv[1], "w"))
distributed.shutdown()
"""


@pytest.fixture(scope="module")
def one_rank_group(tmp_path_factory):
    """The script above as rank 0 of a world of one (torchrun's variables)."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path_factory.mktemp("one_rank") / "out.json"
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    subprocess.run([sys.executable, "-c", _ONE_RANK, str(out)], env=env, check=True,
                   cwd=Path(__file__).resolve().parent.parent, timeout=600)
    return json.loads(out.read_text())


@pytest.mark.cuda
def test_parity_train_steps_in_a_one_rank_nccl_group_equal_the_plain_steps(one_rank_group):
    """Two parity train steps at the qinco2-S widths (M=4) with the mesh of
    a one-rank NCCL group (its all-reduces the identity) and without one:
    parameters, model state and losses equal bit for bit."""
    assert one_rank_group["world"] == 1 and one_rank_group["grouped"]
    assert one_rank_group["step_equal"]


@pytest.mark.cuda
def test_sharded_coarse_topk_in_a_one_rank_group_equals_sqdist_topk(one_rank_group):
    """The sharded top-64 over a 2^16-row book (shard, gather and merge on
    the card) gives the plain top-k's ids."""
    assert one_rank_group["topk_equal"]


@pytest.mark.cuda
def test_sharded_ivf_assign_in_a_one_rank_group_equals_the_plain_loop(one_rank_group):
    """The sharded IVF assignment over the same book (each shard through the
    IVF step's kernel, then the first minimum over the shards) gives the
    plain loop's ids."""
    assert one_rank_group["ivf_equal"]


# D = 768 (Contriever's width): B2 and B3 where their plans take D in
# column passes (B2 at the qinco2-M and -L widths, B3 at all three; B2 at
# qinco2-S still holds D whole, on 64-pair tiles), and one case at D = 256.
WIDE = {
    "S768": dict(D=768, K=256, L=2, de=128, dh=256, A=16, B=32),
    "M768": dict(D=768, K=256, L=4, de=384, dh=384, A=16, B=32),
    "L768": dict(D=768, K=256, L=16, de=384, dh=384, A=16, B=32),
    "L256": dict(D=256, K=256, L=16, de=384, dh=384, A=16, B=32),
}
WIDE_PASSED = {"S768": (False, True), "M768": (True, True), "L768": (True, True),
               "L256": (False, False)}  # (B2, B3) take column passes


# (N, F_in, A) of B2's wide cases: a normal step, and the IVF first step,
# where 1001 beam rows leave the last work item ragged
WIDE_STEPS = {"step": (37, 32, 16), "ivf_first": (1001, 1, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("step", sorted(WIDE_STEPS))
@pytest.mark.parametrize("route", ["topa", "vals"])
@pytest.mark.parametrize("case", sorted(WIDE))
def test_selected_scores_wide_rows_match_plain_and_exact(cuda, case, route, step):
    """B2 at bf16, both routes: ids and scores as the plain version's (as
    above), and the scores of its candidates no further from sums exact to
    float64 than the plain version's, up to ``torch_exact``'s multiples."""
    N, F_in, A = WIDE_STEPS[step]
    spec, p = _step(WIDE[case], "bfloat16", seed=21, device=cuda)
    x, xh = _inputs(spec, F_in, N=N, seed=22, device=cuda)
    plan = kernels.selected_launch_plan(spec, xh, kernels.selected_weights(spec, p), A,
                                         route == "topa")
    assert (plan.d_passes > 1) == WIDE_PASSED[case][0]
    assert step == "step" or xh.shape[0] % plan.per_item
    vals = _external_vals(spec, p, x, xh, F_in, A) if route == "vals" else None
    got = kernels.selected_scores(spec, x, xh, p, A, vals=vals)
    torch.cuda.synchronize()
    _check_scores(got, kernels.selected_scores_plain(spec, x, xh, p, A, vals=vals), "bfloat16")
    plain = kernels.selected_scores_plain(spec, x, xh, p, A, vals=got)  # the kernel's candidates
    exact = selected_exact(spec, x, xh, p, kernels.unpack_ids(got))
    assert_near_exact(_unpacked(got), _unpacked(plain), exact)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDE))
def test_select_rebuild_wide_rows_match_plain_and_exact(cuda, case):
    """B3 at bf16: codes and parents bit-equal to the plain version's, the
    reconstructions no further from exact sums than the plain version's;
    2 vectors an item, so the 301st is alone in the last."""
    spec, p = _step(WIDE[case], "bfloat16", seed=23, device=cuda)
    x, xh = _inputs(spec, 32, N=301, seed=24, device=cuda)
    dists = kernels.selected_scores_plain(spec, x, xh, p, 16).reshape(301, 32 * 16)
    dists[:, 16:32] = dists[:, :16]  # ties: beam 1 repeats beam 0's packed values
    plan = kernels.rebuild_plan(301, 512, 32, spec.D, spec.De, spec.dh, spec.De, bf16=True,
                                low_rank=False, stages=3 + 2 * spec.L, sms=kernels.sm_count(cuda))
    assert (plan.d_passes > 1) == WIDE_PASSED[case][1] and 301 % plan.per_item
    xhat, codes, parents = kernels.select_rebuild(spec, dists, xh, p, 16, 32)
    torch.cuda.synchronize()
    xhat_p, codes_p, parents_p = kernels.select_rebuild_plain(spec, dists, xh, p, 16, 32)
    assert torch.equal(codes, codes_p)
    assert torch.equal(parents, parents_p)
    assert_near_exact(xhat, xhat_p, rebuild_exact(spec, p, xh, codes_p, parents_p))
