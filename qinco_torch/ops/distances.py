"""Squared-L2 distance ops in plain torch
(counterpart of ``qinco_tpu/ops/distances.py``).

Distances use the matmul form ``‖a‖² + ‖b‖² − 2 a·bᵀ`` in float32.  Where
they only rank (argmin / top-k) the constant ``‖a‖²`` is dropped.  Ties
break as the JAX package breaks them: the lowest index first.  On a CUDA
device the IVF step's argmin is one hand-written kernel
(``csrc/nearest.cu``) that never forms the distances in device memory.
"""

from __future__ import annotations

import torch

from .. import tracing


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared norms in float32."""
    x32 = x.float()
    return (x32 * x32).sum(-1)


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """‖a‖² + ‖b‖² − 2 a·bᵀ for ``a (..., d)`` and ``b (k, d)`` -> ``(..., k)``."""
    return sq_norm(a)[..., None] + sq_norm(b) - 2.0 * (a.float() @ b.float().T)


def pairwise_sqdist_partial(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """‖b‖² − 2 a·bᵀ for ``a (..., d)`` and ``b (k, d)`` -> ``(..., k)``:
    rank-equivalent to the full distance along the ``b`` axis."""
    return sq_norm(b) - 2.0 * (a.float() @ b.float().T)


def batch_sqdist_partial(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ‖b‖² − 2 a·bᵀ: ``a (n, p, d)``, ``b (n, q, d)`` -> ``(n, p, q)``."""
    return sq_norm(b)[:, None, :] - 2.0 * torch.bmm(a.float(), b.float().transpose(1, 2))


def topk_smallest(dists: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices and values of the ``k`` smallest entries along the last
    axis, ascending, lowest index first on ties (``lax.top_k`` order; a
    stable sort, since ``torch.topk`` leaves the tie order unspecified)."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return idx[..., :k], vals[..., :k]


def sqdist_topk(a: torch.Tensor, b: torch.Tensor, k: int):
    """Top-k nearest rows of ``b (k_b, d)`` for each row of ``a (..., d)``:
    (indices, partial distances)."""
    return topk_smallest(pairwise_sqdist_partial(a, b), k)


def chunked_argmin(
    x: torch.Tensor, codebook: torch.Tensor, chunk: int = 65536, max_elems: int = 2 ** 28,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-codeword assignment against a huge codebook (the IVF book):
    (codes (N,) int64, best partial distances ‖c‖² − 2 x·c (N,) f32), the
    first minimum, that is the lowest index among equal distances.

    Float32 ``x`` and ``codebook`` on a CUDA device take the fused kernel
    (:func:`qinco_torch.ops.kernels.nearest`: one or two launches, no
    distance tile, ``chunk`` and ``max_elems`` not read); anything else
    takes :func:`chunked_argmin_plain`, and its rows add to the counter
    ``distances.plain_argmin_rows`` while recording (``tracing``).  The
    product is float32 on every route (the JAX package's ``fast`` picks
    its TPU precision, and has no counterpart here)."""
    if x.is_cuda and x.dtype == torch.float32 and codebook.dtype == torch.float32:
        from .kernels import nearest  # ops.kernels imports models, which imports this module
        return nearest(x, codebook)
    tracing.count("distances.plain_argmin_rows", x.shape[0])
    return chunked_argmin_plain(x, codebook, chunk, max_elems)


def chunked_argmin_plain(
    x: torch.Tensor, codebook: torch.Tensor, chunk: int = 65536, max_elems: int = 2 ** 28,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`chunked_argmin` in plain torch, on any device: scans
    ``codebook (K, d)`` in ``chunk``-row slices with a running (best
    distance, best index) carry and ``x`` in row blocks, so the live
    distance tile stays under ``max_elems``.  The carry takes a chunk's
    winner only when it is strictly smaller, so the earlier chunk wins a
    tie, and ``argmin`` within a chunk takes the first minimum."""
    K = codebook.shape[0]
    chunk = min(chunk, K)
    row_block = max(1, max_elems // chunk)
    codes, dists = [], []
    for r0 in range(0, x.shape[0], row_block):
        xr = x[r0:r0 + row_block]
        best_d = torch.full((xr.shape[0],), float("inf"), device=x.device)
        best_i = torch.zeros((xr.shape[0],), dtype=torch.int64, device=x.device)
        for c0 in range(0, K, chunk):
            d = pairwise_sqdist_partial(xr, codebook[c0:c0 + chunk])
            local_d, local_i = d.min(dim=1)
            take = local_d < best_d
            best_i = torch.where(take, local_i + c0, best_i)
            best_d = torch.where(take, local_d, best_d)
        codes.append(best_i)
        dists.append(best_d)
    return torch.cat(codes), torch.cat(dists)
