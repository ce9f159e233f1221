"""OPQ rotation training (counterpart of ``qinco_tpu/ops/opq.py``; the
reference uses ``faiss.OPQMatrix``, ``qinco_v1/pq_qinco.py:104-114``).

Alternates between a product quantizer of the rotated data (k-means per
sub-block, :func:`qinco_torch.ops.kmeans.kmeans`, assignment by
:func:`~qinco_torch.ops.distances.chunked_argmin`, both on the device)
and the Procrustes update ``R = (U Vᵀ)ᵀ`` of ``Xᵀ X̂ = U S Vᵀ``, whose
(D, D) SVD runs in f32 on the host, as in the JAX package.  The k-means
draws come from a ``torch.Generator``, so the rotation differs from the
JAX package's for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device
from .distances import chunked_argmin
from .kmeans import kmeans


def train_opq(
    x: np.ndarray,
    n_parts: int,
    K: int = 256,
    *,
    iters: int = 10,
    kmeans_iters: int = 4,
    seed: int = 0,
    verbose: bool = False,
    device=None,
) -> np.ndarray:
    """An orthogonal (D, D) float32 rotation R for product quantization
    into ``n_parts`` blocks; ``x @ R.T`` is the rotated space."""
    device = resolve_device(device)
    x = np.asarray(x, np.float32)
    D = x.shape[1]
    if D % n_parts:
        raise ValueError(f"D={D} not divisible by n_parts={n_parts}")
    d_sub = D // n_parts
    R = np.eye(D, dtype=np.float32)

    for it in range(iters):
        xr = x @ R.T
        xhat = np.empty_like(xr)
        for p in range(n_parts):
            sl = slice(p * d_sub, (p + 1) * d_sub)
            cent = kmeans(xr[:, sl], K, iters=kmeans_iters, seed=seed + p, device=device)
            codes, _ = chunked_argmin(torch.as_tensor(xr[:, sl], device=device),
                                      torch.as_tensor(cent, device=device))
            xhat[:, sl] = cent[codes.cpu().numpy()]
        # Procrustes: min_R ||x R^T - xhat||_F over orthogonal R
        u, _, vt = np.linalg.svd(x.T @ xhat, full_matrices=False)
        R = (u @ vt).T.astype(np.float32)
        if verbose:
            print(f"OPQ iter {it + 1}/{iters}: rotated PQ err {float(((xr - xhat) ** 2).mean()):g}")
    return R
