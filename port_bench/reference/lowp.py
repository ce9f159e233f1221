"""The control's precision: float8 (e4m3) product inputs, the step below
the bfloat16 that the configurations state for the MLP and substep
products, and TF32 for the IVF product that they state in float32.

A product input is scaled per row (over its last axis) so that its
largest magnitude is e4m3's largest, rounded to e4m3 and scaled back, as
an fp8 GEMM with per-row scales computes.  Under autograd the incoming
gradient is rounded the same way to e5m2 with one scale for the tensor,
as fp8 training keeps its gradients.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype, top: float, dim) -> torch.Tensor:
    amax = t.abs().amax(dim=dim, keepdim=dim is not None).clamp(min=1e-30)
    scale = amax / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX, -1)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX, None)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 with per-row scales (gradient to e5m2)."""
    return _Fp8.apply(t)
