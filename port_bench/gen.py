"""Weights, data and batch order made from the seed.

Frozen copies, not imports, of ``chip_smoke.py`` at commit 3513fb6
(``random_model``, with the draws of ``qinco_torch.models.params``'s
``init_params`` that it starts from, and ``synthetic_data``).  The
benchmark makes these and hands the same tensors to the program and to
the reference; nothing here imports the program.

Departures from the originals: the weights are a dict of plain tensors
(the reference's layout) rather than the program's parameter tuples;
the data's decode runs in blocks of rows; ``BatchOrder`` is new.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import qinco_ref

RELU_GAIN = math.sqrt(2.0)


def _kaiming_uniform(g, shape, fan_in, device) -> torch.Tensor:
    u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
    return (2.0 * u - 1.0) * (RELU_GAIN * math.sqrt(3.0 / fan_in))


def random_weights(shp: qinco_ref.Shape, seed: int, device) -> dict:
    """QINCo2 weights from ``seed``, on ``device``: the draws of
    ``init_params`` (QINCo2 mode: Kaiming-uniform up-projections and
    projections, standard normal codebooks), then ``random_model``'s
    refinement: the zero-initialized concat and FFN-down weights drawn as
    0.1 / sqrt(fan_in) normals, step i's codebook scaled by 0.5^(i+1) as
    residual codebooks are, the substep codebook a copy, and a standard
    normal IVF book."""
    g = torch.Generator(device=device).manual_seed(seed)
    S, D, De, Dh, L, K = shp.M, shp.D, shp.De, shp.Dh, shp.L, shp.K
    W = {"ffn_up": _kaiming_uniform(g, (S, L, De, Dh), De, device)}
    if De != D:
        W["in_proj"] = _kaiming_uniform(g, (S, D, De), D, device)
        W["out_proj"] = _kaiming_uniform(g, (S, De, D), De, device)
    else:
        W["in_proj"] = W["out_proj"] = None
    codebook = torch.randn((S, K, D), generator=g, dtype=torch.float32, device=device)
    fill = lambda shape, fan_in: (0.1 / fan_in ** 0.5) * torch.randn(shape, generator=g,
                                                                      device=device)
    W["concat_w"] = fill((S, De + D, De), De + D)
    W["concat_b"] = fill((S, De), De)
    W["ffn_down"] = fill((S, L, Dh, De), Dh)
    scale = 0.5 ** torch.arange(1, S + 1, device=device, dtype=torch.float32)
    W["codebook"] = codebook * scale[:, None, None]
    W["sub_codebook"] = W["codebook"].clone()
    W["codebook0"] = torch.randn((shp.ivf_K, D), generator=g, device=device)
    W["data_mean"] = torch.zeros((D,), dtype=torch.float32, device=device)
    W["data_std"] = torch.ones((), dtype=torch.float32, device=device)
    return W


def fingerprint(W: dict) -> list:
    """One float64 sum a leaf: tells two makings of the weights apart."""
    return [float(W[k].double().sum()) for k in sorted(W) if W[k] is not None]


@torch.no_grad()
def synthetic_data(W: dict, shp: qinco_ref.Shape, n: int, seed: int, noise: float,
                   block: int = 1 << 16) -> np.ndarray:
    """``n`` raw-space vectors on the host: the f32 decode of random codes
    plus Gaussian noise of std ``noise`` a dimension.  At 0.05 each vector
    lies at the noise floor of its code, where any loss of the encode's
    selection shows at full weight."""
    device = W["codebook0"].device
    g = torch.Generator(device=device).manual_seed(seed + 2)
    ks = [shp.ivf_K] + [shp.K] * shp.M
    codes = torch.stack([torch.randint(0, k, (n,), generator=g, device=device) for k in ks])
    with qinco_ref.strict_f32():
        x = torch.cat([qinco_ref.decode(W, codes[:, r:r + block])
                       for r in range(0, n, block)])
    x = x * W["data_std"] + W["data_mean"]
    x += noise * torch.randn(x.shape, generator=g, device=device)
    return x.cpu().numpy()


class BatchOrder:
    """The host rows of each training step: consecutive slices of a
    permutation of the rows drawn from the seed, a new permutation each
    pass over them; each slice sorted, so the gather reads in order."""

    def __init__(self, seed: int, n_rows: int, batch: int):
        self.seed, self.n_rows, self.batch = seed, n_rows, batch
        self.per_pass = n_rows // batch
        self.epoch, self.perm = None, None

    def rows(self, step: int) -> np.ndarray:
        epoch, k = divmod(step, self.per_pass)
        if epoch != self.epoch:
            rng = np.random.default_rng([self.seed, 3, epoch])
            self.epoch, self.perm = epoch, rng.permutation(self.n_rows)
        return np.sort(self.perm[k * self.batch:(k + 1) * self.batch])
