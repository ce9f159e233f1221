"""The evaluation loop (counterpart of ``qinco_tpu/train/loop.py``):
encode, decode and the weighted squared error of each batch, on the
parameters' device.  The validation MSE of training and the ``eval``,
``eval_time`` and ``eval_valset`` tasks all run :func:`compute_mse`."""

from __future__ import annotations

import itertools

import torch

from ..logsys import MetricLogger
from ..models.qinco import decode_raw, encode
from ..models.spec import QincoSpec
from ..parallel.mesh import TRIVIAL, all_reduce_sum
from ..utils import Timer, host_to_device, sync


@torch.no_grad()
def compute_mse(
    params,
    spec: QincoSpec,
    loader,
    melog: MetricLogger | None = None,
    *,
    mse_scale: float = 1.0,
    timing: bool = False,
    warmup_batches: int = 10,
    mesh=None,
) -> float:
    """Scaled MSE over ``loader``, an iterable of batches with ``.x``
    (raw-space vectors, zero-padded to a fixed length) and ``.n_valid``
    (the count of real rows).  ``melog`` gets the eval's start, each
    batch's squared-error sum and its end.  With ``timing`` it warms up on
    the first batch, fences each encode and decode with a device sync and
    prints μs per vector (this rank's time over its rows).  With a
    ``mesh`` that has a process group, ``loader`` is this rank's shard
    (every rank's of one length) and each batch's squared-error sum and
    valid count are summed over the data axis (one all-reduce a batch), so
    the MSE is the global one on every rank."""
    device = params.codebook0.device
    mesh = mesh or TRIVIAL

    def encode_fn(xb):
        codes, _, _ = encode(params, spec, (xb - params.data_mean) / params.data_std)
        return codes

    it = iter(loader)
    first = next(it, None)
    if first is None:
        return float("nan")
    if timing and warmup_batches:
        xb = host_to_device(first.x, device)
        for _ in range(warmup_batches):
            decode_raw(params, spec, encode_fn(xb))
        sync(device)

    t_encode, t_decode = Timer(), Timer()
    loss_sum, n_vecs, n_local = 0.0, 0, 0
    if melog is not None:
        melog.start_eval(len(loader))
    for i_batch, b in enumerate(itertools.chain([first], it)):
        xb = host_to_device(b.x, device)
        with t_encode:
            codes = encode_fn(xb)
            sync(device)
        with t_decode:
            xhat = decode_raw(params, spec, codes)
            sync(device)
        w = torch.zeros((len(xb),), dtype=torch.float32, device=device)
        w[: b.n_valid] = 1.0
        sums = torch.stack([(((xb - xhat) ** 2) * w[:, None]).sum(), w.sum()])
        (sums,) = all_reduce_sum(mesh, [sums])
        err, n_valid = sums.tolist()
        n_valid = int(n_valid)
        loss_sum += err
        n_vecs += n_valid
        n_local += b.n_valid
        if melog is not None:
            melog.step_eval_sums(i_batch, err, n_valid)

    if timing and mesh.is_main:
        print(f"Encoding time: {t_encode.s()} | Decoding time: {t_decode.s()}")
        print(f"Encoding time / vector: {t_encode.get() / n_local * 1e6:.1f}μs")
        print(f"Decoding time / vector: {t_decode.get() / n_local * 1e6:.1f}μs")
    mse = loss_sum * mse_scale / max(n_vecs, 1)
    if melog is not None:
        melog.end_eval()
        melog.last_val_mse = mse
    return mse
