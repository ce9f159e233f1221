"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n 8192]

1. Prints the card's name and power limit, turns TF32 off.
2. Builds the kernels from ``qinco_torch/csrc`` and prints the seconds.
3. Kernel phase: each kernel against its plain PyTorch version on the
   card at the main paths' shapes (qinco2-S at N=1024 vectors: a normal
   step and the IVF first step) and at the qinco2-M widths (in/out
   projections, L=4), with the tolerances of ``tests/test_torch_cuda.py``;
   one JSON line per kernel and shape with the median ms of one call
   from CUDA events (``ms``) and of back-to-back calls (``ms_batch``,
   where the wrapper's host work overlaps the previous call's kernel),
   the plain version's ms, the bound, the achieved TFLOP/s and the
   kernel's design (tensor cores or CUDA cores):
   - selected scores with the in-kernel top-A (parity profile) and with
     external vals (the f32 folded table of ``pallas=true``, the bf16
     lean table of ``fused_topa=false``); select-rebuild;
   - fused-substep scores (speed profile; also its f32 route);
   - candidate scores at K=1024 (unpacked; also at the qinco2-M widths and
     its f32 route) and at K=256 with a low-rank concat factor (packed),
     and select-rebuild with that factor.
4. Path phase at qinco2-S, random weights and data from ``--seed`` (the
   data: decodes of random codes plus noise of std ``NOISE``, or
   ``SPEED_NOISE`` for the speed profile), through ``encode_chunked``
   (batch 1024) over ``--n`` vectors, then ``decode``: the parity and the
   speed profile without and with the IVF step 0 (ivf_K = 2^20),
   ``pallas=true`` (f32) and the parity profile at K=1024.  Each checks
   the kernels' launch counts exactly (one launch of its scoring kernel
   and, with packed ids, of select-rebuild per MLP step and chunk, none of
   the others), encode xhat against decode(codes), and its MSE and codes
   against ``encode_profile=exact`` on a 1024-vector subset.  Prints
   encode vectors per second (one ``encode_chunked`` over all vectors),
   decode vectors per second (the median of ``DECODE_WINDOWS`` windows of
   ``DECODE_REPS`` decodes of all of them), and the device time by kernel
   of one encode chunk and of one decode (torch.profiler).
5. The kernel summary line, then ``{"ok": true, "device": ...}`` last.

Any failed check raises and the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from qinco_torch.config import load_config
from qinco_torch.models.params import QincoParams, StepParams, init_params
from qinco_torch.models.qinco import decode, decode_raw, encode, encode_chunked
from qinco_torch.models.spec import spec_from_cfg
from qinco_torch.ops import kernels

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# Decode timing: DECODE_WINDOWS windows of DECODE_REPS decodes of all the
# vectors each.  One decode takes milliseconds and is launched op by op
# from the host, so one window's rate follows the host's load; the metric
# is the median window.
DECODE_WINDOWS, DECODE_REPS = 9, 10
# Rank of the low-rank concat factor in the candidate-route checks.
CONCAT_RANK = 64
# Std of the noise added to the data's exact decodes (synthetic_data):
# NOISE for the paths with an exact per-step selection, SPEED_NOISE for the
# speed profile's binned selection, whose loss at NOISE, where each vector
# sits at its exact code's noise floor, exceeds the 1.05x bound in the JAX
# package as in the port (PERF.md, section 6).
NOISE, SPEED_NOISE = 0.05, 0.5

# kernel -> (source, the TPU kernel it replaces)
SOURCES = {
    "selected_scores": ("qinco_torch/csrc/selected_scores.cu",
                        "qinco_tpu/ops/pallas_kernels.py:880"),
    "select_rebuild": ("qinco_torch/csrc/select_rebuild.cu",
                       "qinco_tpu/ops/pallas_kernels.py:1211"),
    "fused_substep_scores": ("qinco_torch/csrc/fused_substep_scores.cu",
                             "qinco_tpu/ops/pallas_kernels.py:483"),
    "candidate_scores": ("qinco_torch/csrc/candidate_scores.cu",
                         "qinco_tpu/ops/pallas_kernels.py:1019"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok, what: str) -> None:
    """A smoke check: raises (and so fails the run) when ``ok`` is false."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, from CUDA events around
    each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def batch_ms(fn, calls: int = 10, windows: int = 5) -> float:
    """Median over ``windows`` of the ms per call of ``calls`` back-to-back
    calls of ``fn()`` between two CUDA events."""
    fn()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def design(dtype: str) -> str:
    """How a kernel computes its MLP products: every kernel runs them on
    the tensor cores under bf16, and in f32 on the CUDA cores under f32."""
    return "tensor cores (mma.sync)" if dtype == "bfloat16" else "cuda cores f32"


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _dims(spec):
    return spec.D, spec.K, spec.De, spec.dh, spec.L


def _ffn_flops(spec, blocks):
    return blocks * 2 * (2 * spec.De * spec.dh)


def _ffn_bytes(spec, esize):
    D, K, De, Dh, L = _dims(spec)
    return 2 * L * De * Dh * esize + (De * D * esize if De != D else 0)


def selected_work(spec, N, F_in, A, esize, external=False):
    """FLOPs and bytes of the selected-scores function at these shapes:
    the substep distances over K (in-kernel top-A only), the condition
    product, and per slot the lean fetch times wfold (``spec.fast``; the
    folded table fetches that column), the FFN blocks, out_proj and the
    distance.  Bytes: x, xh, the packed external vals and the packed output
    once, the step's weights (and the table) once."""
    D, K, De, Dh, L = _dims(spec)
    NF = N * F_in
    per_slot = (2 * D * De if spec.fast else 0) + _ffn_flops(spec, L) + (
        2 * De * D if De != D else 0) + 3 * D
    flops = NF * ((0 if external else 2 * K * D) + 2 * D * De + A * per_slot)
    table = K * (D if spec.fast else D + De) * esize
    weights = (0 if external else K * D * 4) + table + D * De * esize * (2 if spec.fast else 1)
    nbytes = 4 * (N * D + NF * D + NF * A * (2 if external else 1)) + weights + _ffn_bytes(
        spec, esize)
    return flops, nbytes


def fused_work(spec, N, F_in, A, esize):
    """FLOPs and bytes of the fused-substep function (fold_up table):
    substep distances over K, per row the condition product and its
    product with the first up-projection, per slot the rest of FFN block 0,
    blocks 1..L-1, out_proj and the distance.  Bytes: x, xh and the packed
    output once; the substep codebook, the (K, D + De + Dh) table and the
    weights once."""
    D, K, De, Dh, L = _dims(spec)
    NF = N * F_in
    per_slot = 2 * Dh * De + _ffn_flops(spec, L - 1) + (2 * De * D if De != D else 0) + 3 * D
    flops = NF * (2 * K * D + 2 * D * De + 2 * De * Dh + A * per_slot)
    weights = K * D * 4 + K * (D + De + Dh) * esize + D * De * esize + _ffn_bytes(spec, esize)
    nbytes = 4 * (N * D + NF * D + NF * A) + weights
    return flops, nbytes


def _chain_flops(spec, rank):
    """FLOPs of the unfolded step MLP for one pair (_mlp_chain)."""
    D, K, De, Dh, L = _dims(spec)
    concat = 2 * (De + D) * (rank or De) + (2 * rank * De if rank else 0)
    return (2 * D * De if De != D else 0) * 2 + concat + _ffn_flops(spec, L)


def _chain_bytes(spec, rank, esize):
    D, K, De, Dh, L = _dims(spec)
    concat = (De + D) * (rank or De) * esize + (rank * De * esize if rank else 0)
    return concat + _ffn_bytes(spec, esize) + (D * De * esize if De != D else 0)


def candidate_work(spec, NF, A, esize, rank):
    """FLOPs and bytes of candidate scores for NF rows of A ids: the
    condition half of the concat product, rnd(xh)·W2, once per row (it is
    the same for a row's A ids), the rest of the unfolded MLP and the
    distance per pair.  Bytes: x, xh, the ids and the output once, the dt
    codebook and the weights once."""
    D, K = spec.D, spec.K
    cond = 2 * D * (rank or spec.De)
    flops = NF * (cond + A * (_chain_flops(spec, rank) - cond + 3 * D))
    nbytes = 4 * (2 * NF * D + 2 * NF * A) + K * D * esize + _chain_bytes(spec, rank, esize)
    return flops, nbytes


def rebuild_work(spec, N, F_in, A, F_out, esize, rank=None):
    """FLOPs and bytes of select-rebuild: the MLP for N·F_out pairs (the
    selection's compares are not counted).  Bytes: dists, xh, the f32
    codebook and weights read once, xhat, codes and parents written once."""
    D, K = spec.D, spec.K
    flops = N * F_out * _chain_flops(spec, rank)
    nbytes = 4 * (N * F_in * A + N * F_in * D + K * D) + _chain_bytes(spec, rank, esize) + (
        4 * N * F_out * (D + 2))
    return flops, nbytes


def spec_of(preset, *extra, profile="parity"):
    """The spec of a preset at D=128, with extra overrides and an encode
    profile (none for profile=None)."""
    overrides = [f"model_args={preset}", *extra]
    if profile:
        overrides.append(f"encode_profile={profile}")
    return spec_from_cfg(load_config(overrides), D=128)


def random_model(spec, seed: int, device):
    """Parameters from ``seed``: the zero-initialized concat and FFN-down
    weights randomized (else the MLP is a no-op), step codebooks scaled
    down per step as residual codebooks are, a random IVF book."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = init_params(spec, g, device=device)

    def fill(a):  # a small random refinement: 0.1 / sqrt(fan_in) per weight
        if a is None or a.any():
            return a
        fan_in = a.shape[-2] if a.dim() > 2 else a.shape[-1]
        return (0.1 / fan_in ** 0.5) * torch.randn(a.shape, generator=g, device=device)

    steps = StepParams(*(fill(a) for a in p.steps))
    scale = 0.5 ** torch.arange(1, spec.n_mlp_steps + 1, device=device, dtype=torch.float32)
    steps = steps._replace(codebook=steps.codebook * scale[:, None, None])
    if steps.sub_codebook is not None:
        steps = steps._replace(sub_codebook=steps.codebook.clone())
    codebook0 = p.codebook0
    if spec.ivf_in_use:
        codebook0 = torch.randn((spec.ivf_K, spec.D), generator=g, device=device)
    return QincoParams(codebook0, steps, p.data_mean, p.data_std)


def synthetic_data(spec, params, n: int, seed: int, noise: float) -> np.ndarray:
    """``n`` raw-space vectors on the host: the exact decode of random codes
    plus Gaussian noise of std ``noise`` per dimension (the decodes spread
    by about 1.15 per dimension).  At 0.05 (``NOISE``) each vector lies at
    the noise floor of its exact code, where any pre-selection's loss shows
    at full weight; at 0.5 (``SPEED_NOISE``) the exact encode's relative
    error is 6-8% at D=32 and 64."""
    device = params.codebook0.device
    g = torch.Generator(device=device).manual_seed(seed + 2)
    codes = torch.stack([torch.randint(0, k, (n,), generator=g, device=device)
                         for k in spec.K_vals])
    x = decode_raw(params, spec.with_(compute_dtype="float32"), codes)
    x = x + noise * torch.randn(x.shape, generator=g, device=device)
    return x.cpu().numpy()


def _unpacked(v):
    return (v.view(torch.int32) & ~0xFF).view(torch.float32)


def compare_scores(label, got, want, dtype) -> float:
    """Packed scores: ids agree on >= 99.5% (f32) / 98% (bf16) of slots,
    and where they agree the distances within rtol 1e-4 / 1e-2."""
    same = kernels.unpack_ids(got) == kernels.unpack_ids(want)
    agree = same.float().mean().item()
    need = 0.995 if dtype == "float32" else 0.98
    check(agree >= need, f"{label}: ids agree on {agree:.4f} < {need}")
    dg, dw = _unpacked(got)[same], _unpacked(want)[same]
    torch.testing.assert_close(dg, dw, rtol=1e-4 if dtype == "float32" else 1e-2, atol=1e-4)
    return (dg - dw).abs().max().item()


def kernel_check(name, label, spec, run, plain, compare, work, **info) -> dict:
    """One kernel against its plain version at one shape: the comparison,
    the kernel's and the plain version's median ms, the bound, the achieved
    TFLOP/s; one JSON line."""
    got, want = run(), plain()
    err = compare(got, want)
    flops, nbytes = work
    b_ms, b_by = bound_ms(flops, nbytes, spec.compute_dtype)
    ms = time_ms(run)
    res = dict(name=name, shape=label, **info, design=design(spec.compute_dtype),
               max_abs_err=err, ms=ms, ms_batch=batch_ms(run), plain_ms=time_ms(plain, reps=5),
               bound_ms=b_ms, bound_by=b_by, library_ms=None, gflop=flops / 1e9,
               tflops=flops / ms / 1e9, mbytes=nbytes / 1e6)
    emit({"kernel_check": res})
    return res


def step_inputs(spec, N, F_in, seed, device):
    p = random_model(spec.with_(ivf_K=0), seed, device).step(0)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((N, spec.D), generator=g, device=device)
    xh = x.repeat_interleave(F_in, 0) + 0.7 * torch.randn((N * F_in, spec.D), generator=g,
                                                           device=device)
    return p, x, xh


def check_rebuild(label, spec, p, dists, xh, A, F_in) -> dict:
    N = dists.shape[0]
    F_out = min(spec.B, F_in * A)
    esize = 2 if spec.compute_dtype == "bfloat16" else 4

    def compare(got, want):
        (xhat, codes, parents), (xhat_p, codes_p, parents_p) = got, want
        check(torch.equal(codes, codes_p) and torch.equal(parents, parents_p),
              f"select_rebuild {label}: codes or parents differ from the plain version")
        e = (xhat - xhat_p).abs()
        check(e.max() <= 5e-2 and e.mean() <= 1e-3,
              f"select_rebuild {label}: xhat max err {e.max()}, mean {e.mean()}")
        return e.max().item()

    return kernel_check(
        "select_rebuild", label, spec,
        lambda: kernels.select_rebuild(spec, dists, xh, p, A, F_out),
        lambda: kernels.select_rebuild_plain(spec, dists, xh, p, A, F_out), compare,
        rebuild_work(spec, N, F_in, A, F_out, esize, spec.concat_rank), N=N, F_in=F_in, A=A,
        F_out=F_out)


def check_selected(label, spec, N, F_in, A, seed, device, external=False) -> dict:
    """Selected scores (and, for the in-kernel route, select-rebuild on its
    output) at one shape; external=True feeds the packed exact top-A of the
    f32 substep distances (the external-vals route)."""
    esize = 2 if spec.compute_dtype == "bfloat16" else 4
    p, x, xh = step_inputs(spec, N, F_in, seed, device)
    vals = None
    if external:
        r = x.repeat_interleave(F_in, 0) - xh
        sub = p.sub_codebook
        ids = torch.arange(spec.K, device=device)[None, :]
        packed = kernels.pack_ids_f32((sub * sub).sum(1) - 2.0 * (r @ sub.T), ids)
        vals = torch.sort(packed, dim=1, stable=True).values[:, :A].contiguous()
    res = {"selected_scores": kernel_check(
        "selected_scores", label, spec,
        lambda: kernels.selected_scores(spec, x, xh, p, A, vals=vals),
        lambda: kernels.selected_scores_plain(spec, x, xh, p, A, vals=vals),
        lambda got, want: compare_scores(f"selected_scores {label}", got, want,
                                         spec.compute_dtype),
        selected_work(spec, N, F_in, A, esize, external), N=N, F_in=F_in, A=A,
        route="external vals" if external else "in-kernel top-A",
        table="lean" if spec.fast else "folded")}
    if not external:
        dists = kernels.selected_scores_plain(spec, x, xh, p, A).reshape(N, F_in * A)
        res["select_rebuild"] = check_rebuild(label, spec, p, dists, xh, A, F_in)
    return res


def check_fused(label, spec, N, F_in, A, seed, device) -> dict:
    esize = 2 if spec.compute_dtype == "bfloat16" else 4
    p, x, xh = step_inputs(spec, N, F_in, seed, device)
    return kernel_check(
        "fused_substep_scores", label, spec,
        lambda: kernels.fused_substep_scores(spec, x, xh, p, A),
        lambda: kernels.fused_substep_scores_plain(spec, x, xh, p, A),
        lambda got, want: compare_scores(f"fused_substep_scores {label}", got, want,
                                         spec.compute_dtype),
        fused_work(spec, N, F_in, A, esize), N=N, F_in=F_in, A=A)


def check_candidate(label, spec, N, F_in, A, seed, device) -> dict:
    """Candidate scores for random ids (packed for K <= 256); with a
    low-rank factor, select-rebuild on the packed output too."""
    esize = 2 if spec.compute_dtype == "bfloat16" else 4
    p, x, xh = step_inputs(spec, N, F_in, seed, device)
    x_f = x.repeat_interleave(F_in, 0)
    g = torch.Generator(device=device).manual_seed(seed + 3)
    idx = torch.randint(0, spec.K, (N * F_in, A), generator=g, device=device, dtype=torch.int32)
    pack = spec.K <= 256
    rtol = 1e-4 if spec.compute_dtype == "float32" else 1e-2

    def compare(got, want):
        if pack:
            check(torch.equal(kernels.unpack_ids(got), idx),
                  f"candidate_scores {label}: packed ids are not the given ids")
            got, want = _unpacked(got), _unpacked(want)
        torch.testing.assert_close(got, want, rtol=rtol, atol=1e-4)
        return (got - want).abs().max().item()

    res = {"candidate_scores": kernel_check(
        "candidate_scores", label, spec,
        lambda: kernels.candidate_scores(spec, x_f, xh, idx, p, pack_ids=pack),
        lambda: kernels.candidate_scores_plain(spec, x_f, xh, idx, p, pack_ids=pack), compare,
        candidate_work(spec, N * F_in, A, esize, spec.concat_rank), N=N, F_in=F_in, A=A,
        K=spec.K, packed=pack, concat_rank=spec.concat_rank)}
    if pack:
        dists = kernels.candidate_scores_plain(spec, x_f, xh, idx, p, pack_ids=True)
        res["select_rebuild"] = check_rebuild(label, spec, p, dists.reshape(N, F_in * A), xh,
                                              A, F_in)
    return res


def device_breakdown(fn) -> dict:
    """Device time by kernel over one call of ``fn``, from torch.profiler,
    with the call's wall time: the device's busy share is their ratio."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                top=[[name[:80], ms, n] for name, (ms, n) in top])


def run_path(label, spec, params, x_raw, batch, device, scorer, noise, mse_bound, min_agree):
    """A main path: encode_chunked then decode, with the launch counts read
    around it; then its checks against decode and the exact profile.
    ``scorer`` is the scoring kernel of every MLP step; select-rebuild
    follows it where the ids are packed (K <= 256)."""
    n = len(x_raw)
    encode_chunked(params, spec, x_raw[:batch], batch=batch)  # warm-up chunk
    torch.cuda.synchronize()

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    codes = encode_chunked(params, spec, x_raw, batch=batch)
    t1 = time.perf_counter()
    codes_d = torch.from_numpy(codes).to(device)
    xdec = decode_raw(params, spec, codes_d)  # checked below; warms decode up
    decode_rates = []
    for _ in range(DECODE_WINDOWS):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(DECODE_REPS):
            decode_raw(params, spec, codes_d)
        torch.cuda.synchronize()
        decode_rates.append(n * DECODE_REPS / (time.perf_counter() - t2))
    launches = dict(kernels.LAUNCHES)

    per_step = spec.n_mlp_steps * -(-n // batch)
    used = {scorer} | ({"select_rebuild"} if spec.K <= 256 else set())
    want = {k: per_step if k in used else 0 for k in kernels.LAUNCHES}
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    check(codes.shape == (spec.M_ivf, n) and codes.min() >= 0, f"{label}: bad codes")
    check(bool(torch.isfinite(xdec).all()), f"{label}: decode is not finite")

    # encode's own xhat against decode of its codes (bf16 tolerance)
    sub = slice(0, batch)
    x_sub = torch.from_numpy(x_raw[sub]).to(device)
    x_n = (x_sub - params.data_mean) / params.data_std
    codes_e, xhat_e, _ = encode(params, spec, x_n)
    check(torch.equal(codes_e.cpu(), torch.from_numpy(codes[:, sub])),
          f"{label}: encode of a chunk differs from encode_chunked")
    xhat_dec = decode(params, spec, codes_e)
    rel = (((xhat_e - xhat_dec) ** 2).mean() / (xhat_dec ** 2).mean()).item()
    check(rel <= 1e-4, f"{label}: encode xhat vs decode relative MSE {rel}")

    # the profile against the exact (f32, plain) profile
    spec_x = spec.with_(pallas=False, fast=False, compute_dtype="float32")
    codes_x, _, _ = encode(params, spec_x, x_n)
    mse = lambda c: ((x_sub - decode_raw(params, spec, c)) ** 2).sum(-1).mean().item()
    mse_x = ((x_sub - decode_raw(params, spec_x, codes_x)) ** 2).sum(-1).mean().item()
    mse_p = mse(codes_e)
    agree = (codes_e == codes_x).float().mean().item()
    check(mse_p <= mse_bound * mse_x, f"{label}: MSE {mse_p} > {mse_bound} x exact {mse_x}")
    check(min_agree is None or agree >= min_agree,
          f"{label}: code agreement with exact {agree} < {min_agree}")

    # where one chunk's and one decode's time goes (the counts are read above already)
    chunk = x_raw[:batch]
    breakdown = device_breakdown(lambda: encode_chunked(params, spec, chunk, batch=batch))
    decode_breakdown = device_breakdown(lambda: decode_raw(params, spec, codes_d))
    res = dict(path=label, n=n, batch=batch, noise=noise, launches=launches, breakdown=breakdown,
               decode_breakdown=decode_breakdown,
               encode_vec_s=n / (t1 - t0), decode_vec_s=statistics.median(decode_rates),
               decode_window_vec_s=decode_rates, encode_s=t1 - t0, mse_profile=mse_p,
               mse_exact=mse_x, mse_ratio=mse_p / mse_x, code_agreement=agree,
               xhat_vs_decode_rel_mse=rel)
    emit({"path": res})
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=8192, help="vectors per encode run")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t = time.perf_counter()
    reports = kernels.build()
    emit({"build_s": time.perf_counter() - t, "ptxas": {
        name: re.findall(r"Used \d+ registers|\d+ bytes spill stores", log)
        for name, log in reports.items()}})

    N, seed = 1024, args.seed
    s, m = spec_of("qinco2-S"), spec_of("qinco2-M")
    speed_s, speed_m = spec_of("qinco2-S", profile="speed"), spec_of("qinco2-M", profile="speed")
    main_shape = {}  # kernel -> its check at its main path's shape, for the summary line

    res = check_selected("qinco2-S", s, N, s.B, s.A, seed, device)
    main_shape.update(res)
    check_selected("qinco2-S IVF first step", s, N, 1, max(s.B, s.A), seed, device)
    check_selected("qinco2-M", m, N, m.B, m.A, seed, device)
    main_shape["fused_substep_scores"] = check_fused(
        "qinco2-S speed", speed_s, N, s.B, s.A, seed, device)
    check_fused("qinco2-S speed IVF first step", speed_s, N, 1, max(s.B, s.A), seed, device)
    check_fused("qinco2-M speed", speed_m, N, m.B, m.A, seed, device)
    check_selected("qinco2-S pallas=true (f32, folded table)",
                   spec_of("qinco2-S", "pallas=true", profile=None), N, s.B, s.A, seed, device,
                   external=True)
    check_selected("qinco2-S parity fused_topa=false (bf16, lean table)",
                   spec_of("qinco2-S", "fused_topa=false"), N, s.B, s.A, seed, device,
                   external=True)
    main_shape["candidate_scores"] = check_candidate(
        "qinco2-S widths K=1024", spec_of("qinco2-S", "K=1024"), N, s.B, s.A, seed,
        device)["candidate_scores"]
    check_candidate(f"qinco2-S concat_rank={CONCAT_RANK}", s.with_(concat_rank=CONCAT_RANK),
                    N, s.B, s.A, seed, device)
    check_candidate("qinco2-M widths K=1024", spec_of("qinco2-M", "K=1024"), N, m.B, m.A, seed,
                    device)
    # the f32 routes of B4 and B5: their CUDA-core kernels
    check_fused("qinco2-S speed f32", speed_s.with_(compute_dtype="float32"), N, s.B, s.A, seed,
                device)
    check_candidate("qinco2-S widths K=1024 f32",
                    spec_of("qinco2-S", "K=1024").with_(compute_dtype="float32"), N, s.B, s.A,
                    seed, device)

    # (label, spec, scoring kernel, data noise, MSE bound and least code
    # agreement vs exact)
    paths = [
        ("qinco2-S", s, "selected_scores", NOISE, 1.01, 0.9),
        ("qinco2-S IVF 2^20", spec_of("qinco2-S", "ivf_in_use=true"), "selected_scores", NOISE,
         1.01, 0.9),
        ("qinco2-S speed", speed_s, "fused_substep_scores", SPEED_NOISE, 1.05, None),
        ("qinco2-S speed IVF 2^20", spec_of("qinco2-S", "ivf_in_use=true", profile="speed"),
         "fused_substep_scores", SPEED_NOISE, 1.05, None),
        ("qinco2-S pallas=true", spec_of("qinco2-S", "pallas=true", profile=None),
         "selected_scores", NOISE, 1.01, 0.95),
        ("qinco2-S K=1024", spec_of("qinco2-S", "K=1024"), "candidate_scores", NOISE, 1.01,
         0.9),
    ]
    launches = {k: 0 for k in kernels.LAUNCHES}
    for label, spec, scorer, noise, mse_bound, min_agree in paths:
        params = random_model(spec, seed, device)
        x_raw = synthetic_data(spec, params, args.n, seed, noise)
        res = run_path(label, spec, params, x_raw, N, device, scorer, noise, mse_bound,
                       min_agree)
        for k, v in res["launches"].items():
            launches[k] += v
        del params
        torch.cuda.empty_cache()

    emit({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=replaces, launches=launches[k],
             max_abs_err=main_shape[k]["max_abs_err"], ms=main_shape[k]["ms"],
             plain_ms=main_shape[k]["plain_ms"], bound_ms=main_shape[k]["bound_ms"],
             bound_by=main_shape[k]["bound_by"], library_ms=None,
             tflops=main_shape[k]["tflops"], design=main_shape[k]["design"],
             ms_batch=main_shape[k]["ms_batch"])
        for k, (src, replaces) in SOURCES.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
