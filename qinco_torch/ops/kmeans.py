"""Lloyd k-means on the device (counterpart of ``qinco_tpu/ops/kmeans.py``).

Assignment is :func:`qinco_torch.ops.distances.chunked_argmin` (a
matmul argmin over codebook chunks); the update sums each cluster's rows
into ``(K, D)`` sums with :func:`qinco_torch.ops.segment.segment_sum`
(the same bits on every run, on the card too) and counts them with
``bincount``, on the device.  The rows stay on the device across iterations when they fit in
``RESIDENT_BYTES``, else each iteration streams them up in ``batch``-row
blocks.

- init: uniform in [0, 1) times the per-dimension std, plus the mean, of
  the first 200k rows (numpy's float32 mean and population std), unless
  ``init_centroids`` is given;
- an empty cluster is refilled with such a draw;
- 10 Lloyd iterations by default.

With a ``mesh`` that has a process group the rows split contiguously over
its data axis; each iteration all-reduces the sums and the counts once
(one f32 and one int64 collective) before the refill and the division.
The init and the refills draw from one seeded generator on every rank, so
every rank ends with the same centroids.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import TRIVIAL, all_reduce_sum
from ..utils import resolve_device
from .distances import chunked_argmin
from .segment import segment_sum

# Rows per assignment step, under a budget of 2^27 elements (512 MB in
# f32) for the (rows, chunk) distance tile.
DIST_BUDGET_ELEMS = 2**27
# The rows stay on the device when they take at most this many bytes.
RESIDENT_BYTES = 8 * 2**30


def accumulate_pass(xb: torch.Tensor, centroids: torch.Tensor, sums: torch.Tensor,
                    counts: torch.Tensor, *, chunk: int, rows: int) -> None:
    """One assignment-and-accumulate pass over the rows ``xb``: each
    ``rows``-row step assigns its rows to the nearest of ``centroids``
    (``chunked_argmin``, f32) and adds them into ``sums (K, D)`` and
    ``counts (K,)`` in place."""
    K = centroids.shape[0]
    for r0 in range(0, len(xb), rows):
        xr = xb[r0:r0 + rows]
        codes, _ = chunked_argmin(xr, centroids, chunk=chunk)
        sums += segment_sum(xr, codes, K)
        counts += torch.bincount(codes, minlength=K)


def kmeans(
    x: np.ndarray,
    K: int,
    *,
    iters: int = 10,
    seed: int = 0,
    batch: int = 1_000_000,
    chunk: int = 65536,
    init_centroids: np.ndarray | None = None,
    verbose: bool = False,
    device=None,
    mesh=None,
) -> np.ndarray:
    """Train K centroids on ``x (N, D)`` (array-like, a memmap say) on
    ``device`` (default ``cuda``); returns (K, D) float32 on the host.  The
    draws come from a ``torch.Generator`` on the device seeded with
    ``seed``.  With ``mesh`` (see the module docstring) every rank passes
    all of ``x`` and reads its data shard's rows of it."""
    device = resolve_device(device)
    N, D = x.shape
    g = torch.Generator(device=device).manual_seed(seed)
    mesh = mesh or TRIVIAL

    stats = np.asarray(x[: min(N, 200_000)], np.float32)
    mean = torch.as_tensor(stats.mean(0), device=device)
    std = torch.as_tensor(stats.std(0), device=device)
    if init_centroids is not None:
        centroids = torch.as_tensor(np.asarray(init_centroids, np.float32), device=device)
    else:
        centroids = torch.rand((K, D), generator=g, device=device) * std + mean

    per = N // mesh.data_size  # this data shard's rows; the last shard takes the rest
    lo = per * mesh.data_rank
    x = np.asarray(x[lo:N if mesh.data_rank == mesh.data_size - 1 else lo + per], np.float32)
    if not x.flags.writeable:  # a read-only memmap: a copy in memory
        x = x.copy()
    chunk = min(chunk, K)
    rows = int(max(256, min(batch, DIST_BUDGET_ELEMS // chunk)))
    bounds = [(lo, min(len(x), lo + batch)) for lo in range(0, len(x), batch)]
    resident = len(x) * D * 4 <= RESIDENT_BYTES
    blocks = [torch.as_tensor(x[lo:hi], device=device) for lo, hi in bounds] if resident else None

    for it in range(iters):
        sums = torch.zeros((K, D), dtype=torch.float32, device=device)
        counts = torch.zeros((K,), dtype=torch.int64, device=device)
        for i, (lo, hi) in enumerate(bounds):
            xb = blocks[i] if resident else torch.as_tensor(x[lo:hi], device=device)
            accumulate_pass(xb, centroids, sums, counts, chunk=chunk, rows=rows)
        sums, counts = all_reduce_sum(mesh, [sums, counts])
        refill = torch.rand((K, D), generator=g, device=device) * std + mean
        empty = counts < 0.5
        sums = sums + refill * empty[:, None]
        centroids = sums / torch.clamp(counts, min=1.0)[:, None]
        if verbose and mesh.is_main:
            print(f"kmeans iter {it + 1}/{iters}")
    return centroids.cpu().numpy()
