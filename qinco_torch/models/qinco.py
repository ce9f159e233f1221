"""QINCo2 decode, beam-search encode and training losses in PyTorch
(counterpart of ``qinco_tpu/models/qinco.py``).

The functions keep the JAX package's names, shapes and layouts: codes are
``(M_ivf, N)`` int32, reconstructions are in normalized space, and every
matmul accumulates in float32 with its inputs rounded to
``spec.compute_dtype``.  Loops over steps are Python loops (the JAX
``lax.scan``); the beam step routes as the JAX one does:

- ``encode_profile=exact`` (``pallas=False``) runs :func:`_beam_step`'s
  plain branch in torch;
- ``pallas`` runs the hand-written kernels of
  :mod:`qinco_torch.ops.kernels` on a CUDA tensor (their plain versions
  on a CPU tensor), scoring with
  - the fused-substep kernel under ``fused_substep`` (``encode_profile=
    speed``; power-of-two K <= 256 and A | K),
  - the selected-scores kernel with its in-kernel exact top-A under
    ``fast`` + ``fused_topa`` (``encode_profile=parity``), or with the
    top-A taken outside (the external-vals route: ``pallas`` alone, or
    ``fused_topa=False``),
  - the candidate-scores kernel for K > 256 or ``concat_rank``,
  then selecting and rebuilding in :func:`_select_rebuild` (the
  select-rebuild kernel; torch for K > 256, which packs no ids).

Every encode route of the JAX package runs here; where the JAX package
takes an approximate top-k (a TPU operation) the port takes the exact
one, as JAX does on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..ops import kernels
from ..ops.distances import (
    batch_sqdist_partial,
    chunked_argmin,
    pairwise_sqdist_partial,
    sqdist_topk,
    topk_smallest,
)
from ..ops.segment import gather_rows
from .params import QincoParams, StepParams
from .spec import QincoSpec


class EncodeStats(NamedTuple):
    """Per-MLP-step residual statistics feeding the EMA buffers."""

    xtarget_mean: torch.Tensor  # (Ms, D)
    xtarget_std: torch.Tensor  # (Ms, D)


# ---------------------------------------------------------------------------
# The per-step MLP
# ---------------------------------------------------------------------------


def step_predict(
    spec: QincoSpec, p: StepParams, cand: torch.Tensor, cond: torch.Tensor
) -> torch.Tensor:
    """Map raw codewords ``cand (..., A, D)`` conditioned on the current
    reconstruction ``cond (..., D)`` to predicted codewords (..., A, D),
    float32: in_proj -> residual concat-MLP -> L residual FFN blocks ->
    out_proj [-> + raw codeword in QINCo2 mode].

    Under autograd every product input is rounded once more (``arg``): a
    no-op forward, whose backward rounds that use's cotangent to
    ``compute_dtype`` on its own before the uses' cotangents are summed,
    as JAX transposes a product of a bf16 value."""
    rnd = kernels.rounder(spec)
    arg = rnd if torch.is_grad_enabled() else (lambda t: t)
    h = rnd(cand)
    cond_b = rnd(cond.unsqueeze(-2).expand(cand.shape))
    if p.in_proj is not None:
        h = rnd(arg(h) @ rnd(p.in_proj))
    cc = arg(torch.cat([h, cond_b], dim=-1)) @ rnd(p.concat_w)
    if p.concat_w2 is not None:  # QINCo-LR low-rank factor
        cc = rnd(cc) @ rnd(p.concat_w2)
    cc = cc + p.concat_b
    h = rnd(h + rnd(cc))
    for l in range(spec.L):
        up = rnd(torch.relu(arg(h) @ rnd(p.ffn_up[l])))
        h = rnd(h + rnd(up @ rnd(p.ffn_down[l])))
    out = arg(h) @ rnd(p.out_proj) if p.out_proj is not None else h
    if spec.res_codeword_coeff:
        out = out + cand.float()
    return out


def step_decode(
    spec: QincoSpec, p: StepParams, codes: torch.Tensor, xhat: torch.Tensor
) -> torch.Tensor:
    """Decode one step: predicted codeword for ``codes (N,)`` given
    ``xhat (N, D)``."""
    cw = gather_rows(p.codebook, codes)
    return step_predict(spec, p, cw[:, None, :], xhat)[:, 0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode(params: QincoParams, spec: QincoSpec, codes: torch.Tensor) -> torch.Tensor:
    """Additive decode of ``codes (M_ivf, N) -> xhat (N, D)`` in
    normalized space."""
    if codes.shape[0] != spec.M_ivf:
        raise ValueError(f"codes must have {spec.M_ivf} rows, got {codes.shape[0]}")
    codes = codes.long()
    xhat = params.codebook0[codes[0]]
    for i in range(spec.n_mlp_steps):
        xhat = xhat + step_decode(spec, params.step(i), codes[i + 1], xhat)
    return xhat


def decode_raw(params: QincoParams, spec: QincoSpec, codes: torch.Tensor) -> torch.Tensor:
    """Decode to raw data space (denormalized)."""
    return decode(params, spec, codes) * params.data_std + params.data_mean


# ---------------------------------------------------------------------------
# Beam-search encode
# ---------------------------------------------------------------------------


def _local(tensors: list) -> list:
    """The ``reduce`` of one process: the tensors as they are."""
    return tensors


def _target_stats(x_target: torch.Tensor, w: Optional[torch.Tensor], reduce=_local):
    """Per-dim mean/std of the residual target ``(N, F_in, D)``, optionally
    weighted by the padding mask ``w (N,)``; the mean divides by the
    real row count.  ``reduce`` (a list of tensors -> their sums over the
    data-parallel ranks) sums the weighted sums and counts, then the
    squared deviations from the global mean, before each division: the
    two-pass statistics of the global batch.  The unweighted case is one
    process's."""
    if w is None:
        return x_target.mean(dim=(0, 1)), x_target.std(dim=(0, 1), correction=1)
    n = w.sum() * x_target.shape[1]
    wf = w[:, None, None]
    t_sum, n = reduce([(x_target * wf).sum(dim=(0, 1)), n])
    t_mean = t_sum / torch.clamp(n, min=1.0)
    (sq,) = reduce([((x_target - t_mean) ** 2 * wf).sum(dim=(0, 1))])
    return t_mean, torch.sqrt(sq / torch.clamp(n - 1.0, min=1.0))


def _maybe_target_stats(spec, x, xhat, w, want_stats, reduce=_local):
    """EncodeStats feed training only; inference skips the reduction."""
    if not want_stats:
        z = torch.zeros((x.shape[-1],), dtype=torch.float32, device=x.device)
        return z, z
    return _target_stats(x[:, None, :] - xhat, w, reduce)


def _fused_substep_ok(spec: QincoSpec, n_codes: int) -> bool:
    return (
        spec.pallas
        and spec.fused_substep
        and 0 < n_codes <= spec.K <= 256
        and spec.K % n_codes == 0
        and spec.K & (spec.K - 1) == 0
        and n_codes & (n_codes - 1) == 0
    )


def _beam_step(
    spec: QincoSpec,
    p: StepParams,
    x: torch.Tensor,  # (N, D) target
    xhat: torch.Tensor,  # (N, F_in, D)
    F_out: int,
    n_codes: int,
    w: Optional[torch.Tensor] = None,
    want_stats: bool = True,
    reduce=_local,
):
    """One beam-search step.  Returns ``(xhat_next (N, F_out, D), codes
    (N, F_out), parents (N, F_out), (t_mean, t_std))``, beams ascending by
    distance; the caller backtraces the code history once at the end."""
    N, F_in, D = xhat.shape
    NF = N * F_in
    xh = xhat.reshape(NF, D)

    def tail(dists, ids=None):
        return _select_rebuild(spec, p, x, xhat, dists, F_out, n_codes, w, want_stats, ids,
                               reduce)

    if spec.has_substep() and _fused_substep_ok(spec, n_codes):
        # speed profile: binned-argmin selection fused into the scoring kernel
        return tail(kernels.fused_substep_scores(spec, x, xh, p, n_codes))

    if spec.has_substep():
        if (
            spec.fused_topa
            and spec.fast
            and spec.pallas
            and spec.K <= 256
            and n_codes <= spec.K
            and p.concat_w2 is None
        ):  # exact top-A inside the selected-scores kernel
            return tail(kernels.selected_scores(spec, x, xh, p, n_codes))
        # Substep pre-selection outside any kernel, in f32 (the JAX
        # package's HIGHEST precision; its fast profile's DEFAULT precision
        # is f32 on the CPU too), and an exact top-A where JAX's fast
        # profile takes approx_max_k (exact on the CPU as well).
        x_f = x[:, None, :].expand(N, F_in, D).reshape(NF, D)
        sub_d = pairwise_sqdist_partial(x_f - xh, p.sub_codebook)  # (NF, K)
        if spec.pallas and spec.K <= 256 and p.concat_w2 is None:
            # external-vals route: only the winners' packed values enter the kernel
            ids_k = torch.arange(spec.K, dtype=torch.int32, device=x.device)[None, :]
            _, vals = topk_smallest(kernels.pack_ids_f32(sub_d, ids_k), n_codes)
            return tail(kernels.selected_scores(spec, x, xh, p, n_codes, vals=vals))
        top_idx, _ = topk_smallest(sub_d, n_codes)  # (NF, n)
        if spec.pallas:  # candidate route: K > 256 or a low-rank concat factor
            packed = spec.K <= 256
            dists = kernels.candidate_scores(spec, x_f, xh, top_idx, p, pack_ids=packed)
            return tail(dists, None if packed else top_idx)
        book = p.codebook
        if spec.fast:  # the JAX fast route fetches through a bf16 one-hot product
            book = book.to(torch.bfloat16).float()
        cand = book[top_idx]  # (NF, n, D)
        A_eff = n_codes
    else:
        A_eff = spec.K
        cand = p.codebook[None].expand(NF, spec.K, D)
        top_idx = None

    pred = step_predict(spec, p, cand, xh)  # (NF, A_eff, D) f32
    cand_abs = pred + xh[:, None, :]
    flat = cand_abs.reshape(N, F_in * A_eff, D)
    dists = batch_sqdist_partial(x[:, None, :], flat)[:, 0]  # (N, F_in*A_eff)
    sel, _ = topk_smallest(dists, F_out)  # (N, F_out) ascending

    f_in_idx = sel // A_eff
    if top_idx is not None:
        real = torch.gather(top_idx.reshape(N, F_in * A_eff), 1, sel)
    else:
        real = sel % spec.K
    xhat_next = torch.gather(flat, 1, sel[..., None].expand(N, F_out, D))

    t_mean, t_std = _maybe_target_stats(spec, x, xhat, w, want_stats, reduce)
    return xhat_next, real.int(), f_in_idx.int(), (t_mean, t_std)


def _select_rebuild(
    spec: QincoSpec,
    p: StepParams,
    x: torch.Tensor,  # (N, D)
    xhat: torch.Tensor,  # (N, F_in, D)
    dists: torch.Tensor,  # (N·F_in, n_codes) from a scoring kernel
    F_out: int,
    n_codes: int,
    w: Optional[torch.Tensor],
    want_stats: bool,
    ids: Optional[torch.Tensor] = None,  # (N·F_in, n_codes) when dists packs none
    reduce=_local,
):
    """The kernel beam step's tail: the exact beam top-F_out over the
    F_in·n_codes scored candidates, then their reconstructions.

    With packed ids (``ids`` None: every route with K <= 256) the
    select-rebuild kernel does both.  ``spec.fused_select`` does not route
    here: the JAX package's unfused XLA tail computes the same function,
    and its size bound was a TPU measurement.  Without packed ids (the
    candidate route at K > 256) the codes come from ``ids`` and the tail
    runs in torch, as JAX runs it outside any kernel."""
    N, F_in, D = xhat.shape
    xh = xhat.reshape(N * F_in, D)
    dists = dists.reshape(N, F_in * n_codes)
    if ids is None:
        xhat_next, real, f_in_idx = kernels.select_rebuild(
            spec, dists, xh, p, A_eff=n_codes, F_out=F_out)
    else:
        top, _ = topk_smallest(dists, F_out)  # (N, F_out)
        f_in_idx = (top // n_codes).int()
        real = torch.gather(ids.reshape(N, F_in * n_codes), 1, top).int()
        xhat_next = kernels.rebuild_plain(spec, xh, p, real, f_in_idx)

    t_mean, t_std = _maybe_target_stats(spec, x, xhat, w, want_stats, reduce)
    return xhat_next, real, f_in_idx, (t_mean, t_std)


@torch.no_grad()
def encode(
    params: QincoParams,
    spec: QincoSpec,
    x: torch.Tensor,
    ivf_chunk: int = 65536,
    weights: Optional[torch.Tensor] = None,
    want_stats: bool = False,
    reduce=_local,
) -> tuple[torch.Tensor, torch.Tensor, EncodeStats]:
    """Beam-search encode ``x (N, D)`` (normalized space) on ``x``'s device.

    Returns ``(codes (M_ivf, N) int32, xhat (N, D) f32, EncodeStats)``.
    ``weights (N,)`` masks zero-padded rows out of the stats, which are
    zeros unless ``want_stats``; ``reduce`` makes them the statistics
    over every data-parallel rank's rows (``_target_stats``)."""
    x = x.float()
    if spec.ivf_in_use:
        with tracing.span("encode.ivf"):
            codes0, _ = chunked_argmin(x, params.codebook0, chunk=ivf_chunk)
        codes0 = codes0[:, None]  # (N, 1): the beam enters the MLP chain at 1
    else:
        codes0, _ = sqdist_topk(x, params.codebook0, spec.beam0)  # (N, beam0)
    xhat = params.codebook0[codes0].float()  # (N, F0, D)
    return encode_from_coarse(params, spec, x, codes0, xhat, weights, want_stats, reduce)


@torch.no_grad()
def encode_from_coarse(
    params: QincoParams,
    spec: QincoSpec,
    x: torch.Tensor,
    codes0: torch.Tensor,  # (N, F0) step-0 assignment
    xhat: torch.Tensor,  # (N, F0, D) step-0 reconstruction
    weights: Optional[torch.Tensor] = None,
    want_stats: bool = False,
    reduce=_local,
) -> tuple[torch.Tensor, torch.Tensor, EncodeStats]:
    """The MLP beam-search phases given an externally computed step-0
    assignment, with the O(M·N) backtrace of the winning beam."""
    N, D = x.shape
    Ms = spec.n_mlp_steps
    if Ms == 0:
        return codes0[:, 0][None].int(), xhat[:, 0], EncodeStats(
            torch.zeros((0, D), device=x.device), torch.ones((0, D), device=x.device)
        )

    reals, pars, means, stds = [], [], [], []
    for i in range(Ms):
        with tracing.span("encode.step", step_i=i):
            xhat, real, par, (m, s) = _beam_step(
                spec, params.step(i), x, xhat, F_out=spec.B,
                n_codes=spec.n_codes_at(i), w=weights, want_stats=want_stats, reduce=reduce,
            )
        reals.append(real)
        pars.append(par)
        means.append(m)
        stds.append(s)

    # Beams are ascending by distance, so beam 0 of the last step is the
    # winner; one reverse walk over (code, parent) recovers its history.
    # Under approx_beam the winner is re-picked by an exact argmin of the
    # B survivors' f32 distances, as the JAX package does after its
    # approximate per-step top-k (the port's per-step top-k is exact).
    with tracing.span("encode.backtrace"):
        if spec.approx_beam:
            d_fin = ((x[:, None, :] - xhat) ** 2).sum(-1)  # (N, F)
            beam = torch.argmin(d_fin, dim=1, keepdim=True)  # first minimum
            xhat = torch.gather(xhat, 1, beam[..., None].expand(N, 1, D))
        else:
            beam = torch.zeros((N, 1), dtype=torch.long, device=x.device)
        rows = []
        for real, par in zip(reversed(reals), reversed(pars)):
            rows.append(torch.gather(real, 1, beam)[:, 0])
            beam = torch.gather(par, 1, beam).long()
        rows.append(torch.gather(codes0.int(), 1, beam)[:, 0])
        codes = torch.stack(rows[::-1])  # (M_ivf, N)
        return codes, xhat[:, 0], EncodeStats(torch.stack(means), torch.stack(stds))


@torch.no_grad()
def encode_raw(params: QincoParams, spec: QincoSpec, x: torch.Tensor, *, mesh=None,
               **kw) -> torch.Tensor:
    """Encode raw-space vectors; returns codes only.  With a ``mesh`` whose
    model axis is > 1 and an IVF model, ``params.codebook0`` is this
    rank's shard of the IVF book and step 0 runs sharded
    (``parallel/sharded_ops.py``)."""
    x_n = (x - params.data_mean) / params.data_std
    if mesh is not None and spec.ivf_in_use and mesh.model_size > 1:
        from ..parallel.sharded_ops import encode_ivf_sharded

        codes, _, _ = encode_ivf_sharded(mesh, params, spec, x_n)
        return codes
    codes, _, _ = encode(params, spec, x_n, **kw)
    return codes


def default_encode_batch(spec: QincoSpec, enc_max_bs: int = 65536) -> int:
    """Vector micro-batch under the candidate-tensor memory budget."""
    return max(1, enc_max_bs // (spec.B * (spec.A or 1)))


def encode_chunked(
    params: QincoParams,
    spec: QincoSpec,
    x,
    *,
    batch: int | None = None,
    enc_max_bs: int = 65536,
    mesh=None,
) -> np.ndarray:
    """Host-side loop: encode any-length raw-space ``x`` (array-like on
    the host) in fixed-shape chunks on the parameters' device,
    zero-padding the tail.  Chunks go up through pinned memory without
    blocking, and each chunk's codes come back while the next chunk is
    queued.  Returns codes ``(M_ivf, N)`` int32.  ``mesh`` routes step 0
    through the sharded IVF book (see :func:`encode_raw`): every rank of
    the model group must pass the same ``x``, so that all run the same
    chunks in the same order.

    Each chunk is the span ``encode.chunk`` (:mod:`qinco_torch.tracing`),
    which holds its ``encode.upload``, its encode, its ``encode.download``
    and the ``encode.wait`` for the chunk before (the last chunk waits for
    its own codes too)."""
    device = params.codebook0.device
    pin = device.type == "cuda"
    n = len(x)
    bs = batch or default_encode_batch(spec, enc_max_bs)
    out = np.empty((spec.M_ivf, n), dtype=np.int32)
    pending = None  # (chunk, start, n_valid, host codes, copy event) of the chunk in flight

    def drain():
        c, i, n_valid, host, event = pending
        with tracing.span("encode.wait", chunk=c):
            if event is not None:
                event.synchronize()
        out[:, i:i + n_valid] = host.numpy()[:, :n_valid]

    for c, i in enumerate(range(0, n, bs)):
        n_valid = min(bs, n - i)
        with tracing.span("encode.chunk", chunk=c, rows=n_valid, pad_rows=bs - n_valid):
            with tracing.span("encode.upload"):
                # a writable copy of a memmap slice
                chunk = np.array(x[i:i + bs], dtype=np.float32)
                if n_valid < bs:
                    chunk = np.concatenate(
                        [chunk, np.zeros((bs - n_valid, chunk.shape[1]), np.float32)])
                xc = torch.from_numpy(chunk)
                if pin:
                    xc = xc.pin_memory()
                    tracing.count("io.h2d_bytes", xc.nbytes)
                xd = xc.to(device, non_blocking=True)
            codes = encode_raw(params, spec, xd, mesh=mesh)
            with tracing.span("encode.download"):
                host = torch.empty(codes.shape, dtype=torch.int32, pin_memory=pin)
                host.copy_(codes, non_blocking=True)
                event = None
                if pin:
                    event = torch.cuda.Event()
                    event.record()
            if pending is not None:
                drain()
            pending = (c, i, n_valid, host, event)
            if i + bs >= n:
                drain()
    return out


# ---------------------------------------------------------------------------
# Training forward (losses)
# ---------------------------------------------------------------------------


def train_losses(
    params: QincoParams,
    spec: QincoSpec,
    x: torch.Tensor,
    codes: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """Per-step decode losses for fixed ``codes (M_ivf, N)`` from a no-grad
    encode of ``x (N, D)`` (normalized space), with autograd: it calls
    :func:`step_decode` itself, since :func:`decode` runs without grad.
    ``weights (N,)`` masks padded rows.  Returns ``(total, losses)``:
    ``mse_loss`` (step 0's folded in), ``loss_substep`` when A > 0, and
    ``xhat`` (N, D).  The IVF book gets no gradient, and the substep loss
    reaches only the substep codebook.  The codebook gathers' gradients
    are deterministic segment sums (:func:`~qinco_torch.ops.segment.gather_rows`),
    so a step on the card gives the same bits on every run."""
    N = x.shape[0]
    if weights is None:
        weights = torch.ones((N,), dtype=torch.float32, device=x.device)
    denom = torch.clamp(weights.sum(), min=1.0) * spec.D

    def wmean(sq_err):  # (N, D)
        return (sq_err * weights[:, None]).sum() / denom

    codes = codes.long()
    codebook0 = params.codebook0.detach() if spec.ivf_in_use else params.codebook0
    xhat = gather_rows(codebook0, codes[0])
    losses = {}
    if not spec.ivf_in_use:
        losses["mse_loss_step0"] = wmean((xhat - x) ** 2)
    mses, subs = [], []
    for i in range(spec.n_mlp_steps):
        p, c = params.step(i), codes[i + 1]
        xhat_prev = xhat
        xhat = xhat + step_decode(spec, p, c, xhat)
        mses.append(wmean((xhat - x) ** 2))
        if spec.has_substep():
            subs.append(wmean((xhat_prev.detach() + gather_rows(p.sub_codebook, c) - x) ** 2))
    losses["mse_loss"] = torch.stack(mses).sum() + losses.pop("mse_loss_step0", 0.0)
    if spec.has_substep():
        losses["loss_substep"] = torch.stack(subs).sum()
    total = sum(losses.values())
    return total, {**losses, "xhat": xhat}


def train_forward(params: QincoParams, spec: QincoSpec, x_raw: torch.Tensor):
    """Normalize, encode without grad, and the decode losses with grad:
    ``(total, codes, losses, EncodeStats)``."""
    x = (x_raw - params.data_mean.detach()) / params.data_std.detach()
    codes, _, stats = encode(params, spec, x, want_stats=True)
    total, aux = train_losses(params, spec, x, codes)
    return total, codes, aux, stats
