"""Fixed additive-quantizer (AQ) codebooks fitted to given codes
(counterpart of ``qinco_tpu/ops/aq.py``): the least-squares C_m[k]
minimizing ``‖x − Σ_m C_m[code_m]‖²``, with which the index build
approximates QINCo decodes by table look-ups.

- :func:`compute_fixed_aq_codebooks`: the normal equations without the
  (n, M·k) one-hot design matrix — GᵀG is the code co-occurrence counts
  (integer ``bincount``s), Gᵀx the per-(step, code) sums of x
  (:func:`~qinco_torch.ops.segment.segment_sum`), per row batch on the
  device in f32, summed over batches in float64 on the host; then a
  float64 solve with a small ridge, as the JAX package does.
- :func:`compute_fixed_aq_codebooks_backfit`: cyclic refits of one book
  at a time to the conditional mean of its target, shrunk by a
  pseudo-count (optionally toward a prior), for K² = 65536-entry paired
  books where the normal equations do not fit in memory.
- :func:`reconstruct_from_codebooks`: Σ_m C_m[code_m] in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device
from .segment import segment_sum


def _cooccurrence_and_sums(codes: torch.Tensor, x: torch.Tensor, k: int):
    """codes (n, M), x (n, D) on the device -> (GᵀG (M·k, M·k) int64,
    Gᵀx (M·k, D) f32)."""
    M = codes.shape[1]
    gtg = torch.empty((M, k, M, k), dtype=torch.int64, device=codes.device)
    for m1 in range(M):
        for m2 in range(M):
            pair = codes[:, m1] * k + codes[:, m2]
            gtg[m1, :, m2, :] = torch.bincount(pair, minlength=k * k).reshape(k, k)
    gtx = torch.cat([segment_sum(x, codes[:, m], k) for m in range(M)])
    return gtg.reshape(M * k, M * k), gtx


def compute_fixed_aq_codebooks(xt: np.ndarray, train_codes: np.ndarray, k: int, *,
                               batch: int = 262144, ridge: float = 1e-6,
                               device=None) -> np.ndarray:
    """Codebooks ``(M, k, D)`` float32 fitted to ``xt (n, D)`` with codes
    ``train_codes (n, M)``; the sums on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    xt = np.asarray(xt, np.float32)
    train_codes = np.asarray(train_codes)
    nt, M = train_codes.shape
    if len(xt) != nt:
        raise ValueError(f"{len(xt)} vectors for {nt} code rows")
    gtg = np.zeros((M * k, M * k), np.float64)
    gtx = np.zeros((M * k, xt.shape[1]), np.float64)
    for i in range(0, nt, batch):
        g, s = _cooccurrence_and_sums(
            torch.as_tensor(train_codes[i:i + batch], device=device).long(),
            torch.as_tensor(xt[i:i + batch], device=device), k)
        gtg += g.cpu().numpy()
        gtx += s.cpu().numpy()
    # the minimum-norm family of the rank-deficient one-hot system; the
    # ridge keeps unused codes stable
    gtg += np.eye(M * k) * ridge * max(gtg.max(), 1.0)
    sol = np.linalg.solve(gtg, gtx)
    return sol.reshape(M, k, -1).astype(np.float32)


def compute_fixed_aq_codebooks_backfit(
    xt: np.ndarray, train_codes: np.ndarray, k: int, *, sweeps: int = 4,
    shrinkage: float = 8.0, batch: int = 262144, prior: np.ndarray | None = None,
    device=None,
) -> np.ndarray:
    """Backfitting (cyclic coordinate descent) estimate of fixed additive
    codebooks ``(M, k, D)``: each pass refits book m to the mean of
    (residual + its own contribution) per code, with ``shrinkage``
    pseudo-counts per bin pulling sparse bins toward ``prior (M, k, D)``
    (or toward zero).  The residual and books stay on ``device``."""
    device = resolve_device(device)
    xt = torch.as_tensor(np.asarray(xt, np.float32), device=device)
    codes = torch.as_tensor(np.asarray(train_codes, np.int64), device=device)
    nt, M = codes.shape
    D = xt.shape[1]
    resid = xt.clone()
    if prior is not None:
        if prior.shape != (M, k, D):
            raise ValueError(f"prior {prior.shape}, expected {(M, k, D)}")
        prior = torch.as_tensor(np.asarray(prior, np.float32), device=device)
        books = prior.clone()
        for m in range(M):
            for i in range(0, nt, batch):
                resid[i:i + batch] -= books[m][codes[i:i + batch, m]]
    else:
        books = torch.zeros((M, k, D), dtype=torch.float32, device=device)

    for _ in range(sweeps):
        for m in range(M):
            cm = codes[:, m]
            sums = torch.zeros((k, D), dtype=torch.float64, device=device)
            counts = torch.zeros((k,), dtype=torch.float64, device=device)
            for i in range(0, nt, batch):
                c = cm[i:i + batch]
                sums += segment_sum(resid[i:i + batch] + books[m][c], c, k).double()
                counts += torch.bincount(c, minlength=k).double()
            if prior is not None:
                new_book = (sums + shrinkage * prior[m]) / (counts + shrinkage)[:, None]
            else:
                new_book = sums / (counts + shrinkage)[:, None]
            new_book = new_book.float()
            for i in range(0, nt, batch):
                c = cm[i:i + batch]
                resid[i:i + batch] += books[m][c] - new_book[c]
            books[m] = new_book
    return books.cpu().numpy()


def reconstruct_from_codebooks(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Additive reconstruction Σ_m C_m[code_m] of ``codes (n, M)``."""
    codes = np.asarray(codes)
    M = codes.shape[1]
    if codebooks.shape[0] != M:
        raise ValueError(f"{codebooks.shape[0]} codebooks for {M} code columns")
    out = codebooks[0][codes[:, 0]].copy()
    for m in range(1, M):
        out += codebooks[m][codes[:, m]]
    return out
