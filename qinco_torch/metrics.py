"""Metrics: the scaled MSE accumulator, codebook entropy and search recall
(counterpart of ``qinco_tpu/metrics.py``).  The accumulators take sums
already reduced on the device, so a batch costs one host read."""

from __future__ import annotations

import numpy as np


class MSEMetric:
    """Sum-of-squared-error accumulator -> ``sum((x - xhat)²) · scale /
    n_samples``, the scaled per-vector energy."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale
        self.reset()

    def reset(self) -> None:
        self.loss_sum = 0.0
        self.num_samples = 0

    def update_sums(self, sq_err_sum: float, n: int) -> None:
        self.loss_sum += float(sq_err_sum)
        self.num_samples += int(n)

    def compute(self) -> float:
        if not self.num_samples:
            return float("nan")
        return self.loss_sum * self.scale / self.num_samples


def corrected_mse(x, y, mse_scale: float = 1.0) -> float:
    """Scaled per-vector MSE between two vector sets."""
    x, y = np.asarray(x), np.asarray(y)
    if x.shape != y.shape:
        raise ValueError(f"shapes differ: {x.shape}, {y.shape}")
    return float(((x - y) ** 2).mean(0).sum()) * mse_scale


# Entropy logging is skipped when the steps hold more codewords than this
# (a 2^20 IVF book alone would dominate its cost).
ENTROPY_MAX_CODES = 8_388_608


def codebook_entropy(usage_rows) -> list[float]:
    """Shannon entropy (bits) of each step's codeword-usage histogram."""
    out = []
    for u in usage_rows:
        u = np.asarray(u, np.float64)
        total = u.sum()
        if total <= 1e-6:
            out.append(0.0)
            continue
        p = u / total
        p = p[p > 0]
        out.append(float(-(p * np.log2(p)).sum()))
    return out


def compute_recalls(I: np.ndarray, gt: np.ndarray) -> dict[int, float]:
    """recall@{1,10,100}: the share of queries whose true nearest neighbour
    ``gt[:, 0]`` is among the first r results of ``I (nq, >= r)``."""
    I, gt = np.asarray(I), np.asarray(gt)
    if I.ndim != 2 or gt.ndim != 2:
        raise ValueError(f"results {I.shape} and ground truth {gt.shape} must be 2-D")
    return {rank: float((I[:, :rank] == gt[:, :1]).sum() / gt.shape[0]) for rank in (1, 10, 100)}
