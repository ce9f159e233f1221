"""PQ-QINCo: product-split QINCo with an optional OPQ rotation
(counterpart of ``qinco_tpu/models/pq_qinco.py``; the reference's
``qinco_v1/model_qinco.py:185-234``).

A vector is rotated (optional), split into ``n_parts`` blocks, and each
block is encoded by its own QINCo model; the codes concatenate.  All parts
share one spec.  Their parameters stay stacked on a leading part axis, as
in the JAX package (and its ``.pqnpz`` layout); where JAX maps over the
parts with ``vmap``, the port loops over them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils import resolve_device
from .params import QincoParams, StepParams, init_params, params_from_numpy
from .qinco import decode, encode
from .spec import QincoSpec


class PQQincoParams(NamedTuple):
    parts: QincoParams  # leaves stacked on a leading (n_parts,) axis
    opq: Optional[torch.Tensor]  # (D, D) rotation or None
    part_scales: torch.Tensor  # (n_parts,) per-part scale


def part_params(parts: QincoParams, p: int) -> QincoParams:
    """The parameters of part ``p`` (no part axis)."""
    steps = StepParams(*(None if a is None else a[p] for a in parts.steps))
    return QincoParams(parts.codebook0[p], steps, parts.data_mean[p], parts.data_std[p])


def stack_part_params(part_list: Sequence[QincoParams], *, opq: np.ndarray | None = None,
                      part_scales=None) -> PQQincoParams:
    """Stack the parts' parameters on a leading axis."""
    stack = lambda *xs: None if xs[0] is None else torch.stack(xs)
    first = part_list[0]
    parts = QincoParams(
        stack(*(p.codebook0 for p in part_list)),
        StepParams(*(stack(*xs) for xs in zip(*(p.steps for p in part_list)))),
        stack(*(p.data_mean for p in part_list)),
        stack(*(p.data_std for p in part_list)))
    device = first.codebook0.device
    return PQQincoParams(
        parts=parts,
        opq=None if opq is None else torch.as_tensor(opq, dtype=torch.float32, device=device),
        part_scales=(torch.ones((len(part_list),), device=device) if part_scales is None
                     else torch.as_tensor(part_scales, dtype=torch.float32, device=device)))


def init_pq_params(sub_spec: QincoSpec, n_parts: int, generator: torch.Generator | None = None,
                   *, opq: np.ndarray | None, device=None) -> PQQincoParams:
    """Fresh parameters for each part, drawn in turn from ``generator``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return stack_part_params([init_params(sub_spec, generator, device=device)
                              for _ in range(n_parts)], opq=opq)


def pq_params_from_numpy(sub_spec: QincoSpec, leaves: Sequence[np.ndarray], *,
                         opq: np.ndarray | None, part_scales: np.ndarray,
                         device=None) -> PQQincoParams:
    """PQ parameters from the JAX package's stacked leaves (its tree order,
    ``None`` dropped: the ``part_*`` arrays of a ``.pqnpz``)."""
    device = resolve_device(device)
    parts = params_from_numpy(sub_spec, leaves, device=device)
    return PQQincoParams(
        parts=parts,
        opq=None if opq is None else torch.as_tensor(np.asarray(opq, np.float32), device=device),
        part_scales=torch.as_tensor(np.asarray(part_scales, np.float32), device=device))


@torch.no_grad()
def pq_encode(params: PQQincoParams, sub_spec: QincoSpec, n_parts: int,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (N, D)`` raw -> codes ``(n_parts, M_ivf, N)`` int32 and xhat
    ``(N, D)`` raw: rotate by ``opq.T``, split, divide by the part scales,
    normalize by each part's data statistics, encode; the way back
    reverses each step and un-rotates by ``opq``."""
    N, D = x.shape
    x = x.float()
    if params.opq is not None:
        x = x @ params.opq.T
    x_parts = x.reshape(N, n_parts, D // n_parts).transpose(0, 1)  # (P, N, d)
    x_parts = x_parts / params.part_scales[:, None, None]
    codes, xhats = [], []
    for p in range(n_parts):
        pp = part_params(params.parts, p)
        c, xh, _ = encode(pp, sub_spec, (x_parts[p] - pp.data_mean) / pp.data_std)
        codes.append(c)
        xhats.append(xh * pp.data_std + pp.data_mean)
    xhat = torch.stack(xhats) * params.part_scales[:, None, None]
    xhat = xhat.transpose(0, 1).reshape(N, D)
    if params.opq is not None:
        xhat = xhat @ params.opq
    return torch.stack(codes), xhat


@torch.no_grad()
def pq_decode(params: PQQincoParams, sub_spec: QincoSpec, n_parts: int,
              codes: torch.Tensor) -> torch.Tensor:
    """codes ``(n_parts, M_ivf, N)`` -> x ``(N, D)`` raw."""
    xhats = []
    for p in range(n_parts):
        pp = part_params(params.parts, p)
        xhats.append(decode(pp, sub_spec, codes[p]) * pp.data_std + pp.data_mean)
    xhat = torch.stack(xhats) * params.part_scales[:, None, None]
    N = xhat.shape[1]
    out = xhat.transpose(0, 1).reshape(N, -1)
    if params.opq is not None:
        out = out @ params.opq
    return out
