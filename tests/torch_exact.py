"""Sums exact to float64: the reference against which the CUDA tests hold a
bf16 kernel and its plain version alike, where the two differ only in the
order of their float32 sums.  Imports neither JAX nor the JAX package.

At bf16 the step MLP rounds its activations to bf16 after each product.
A sum that lands near a rounding point rounds one way in one summation
order and the other way in another: the value moves by one bf16 unit
(2^-8 relative) and the rest of the MLP carries the move on.  The plain
version (cuBLAS, float32) and a tensor-core kernel both make such flips,
each in its own places, so neither is the truth for the other; sums exact
to float64, rounded at the same points, are.
"""

import torch

from qinco_torch.ops import kernels

# One bf16 unit, relative: half the spacing of bf16 values at a binade's
# bottom, the move of one flipped rounding.
BF16_UNIT = 2.0 ** -8

# The kernel's distance from the exact sums, against the plain version's
# own.  The select-rebuild accuracy table of PERF.md (section 6; the CUDA
# tests' inputs on an H100) gives kernel/plain ratios of at most 1.0 for the max
# |difference| and 2.0-2.9 for the mean (qinco2-S 2.9, -M 2.0, -L 2.25):
# the mma accumulators sum less exactly on average, but flip no value
# further.  The multiples leave room for other inputs.
MAX_MULTIPLE = 2.0
MEAN_MULTIPLE = 4.0


def _mm(a, b):
    return (a.double() @ b.double()).float()


def predict_exact(spec, p, cand, cond):
    """``step_predict`` with every product summed exactly (float64), then
    rounded to float32 and to the compute dtype at the same points."""
    rnd = kernels.rounder(spec)
    h = rnd(cand)
    cond_b = rnd(cond.unsqueeze(-2).expand(cand.shape))
    if p.in_proj is not None:
        h = rnd(_mm(h, rnd(p.in_proj)))
    cc = _mm(torch.cat([h, cond_b], -1), rnd(p.concat_w))
    if p.concat_w2 is not None:
        cc = _mm(rnd(cc), rnd(p.concat_w2))
    h = rnd(h + rnd(cc + p.concat_b))
    for l in range(spec.L):
        up = rnd(torch.relu(_mm(h, rnd(p.ffn_up[l]))))
        h = rnd(h + rnd(_mm(up, rnd(p.ffn_down[l]))))
    out = _mm(h, rnd(p.out_proj)) if p.out_proj is not None else h
    return out + cand.float() if spec.res_codeword_coeff else out


def rebuild_exact(spec, p, xh, codes, parents):
    """``kernels.rebuild_plain`` with exact sums: the reconstructions
    ``(N, F_out, D)`` of the chosen (parent, code) pairs."""
    N, F_out = codes.shape
    F_in = xh.shape[0] // N
    rows = (torch.arange(N, device=xh.device)[:, None] * F_in + parents).reshape(-1)
    cand = p.codebook[codes.reshape(-1).long()][:, None, :]
    return (predict_exact(spec, p, cand, xh[rows])[:, 0] + xh[rows]).reshape(N, F_out, -1)


def assert_near_exact(got, plain, exact):
    """``got`` (a kernel's output) is no further from ``exact`` than the
    plain version is, up to the multiples above, plus a floor of one bf16
    unit of the output's scale: of the largest |exact| for the max
    |difference|, of the mean |exact| for the mean."""
    e_got, e_plain = (got - exact).abs(), (plain - exact).abs()
    max_bound = MAX_MULTIPLE * e_plain.max() + BF16_UNIT * exact.abs().max()
    mean_bound = MEAN_MULTIPLE * e_plain.mean() + BF16_UNIT * exact.abs().mean()
    assert e_got.max() <= max_bound and e_got.mean() <= mean_bound, (
        f"kernel - exact: max {e_got.max().item():.4g} (bound {max_bound.item():.4g}), "
        f"mean {e_got.mean().item():.3g} (bound {mean_bound.item():.3g}); plain - exact: "
        f"max {e_plain.max().item():.4g}, mean {e_plain.mean().item():.3g}")


def selected_exact(spec, x, xh, p, ids):
    """``kernels.selected_scores_plain`` with every product summed exactly
    (float64), rounded at the same points, for the candidates ``ids (NF,
    A)``: the unpacked distances ``(NF, A)``."""
    rnd = kernels.rounder(spec)
    w = kernels.selected_weights(spec, p)
    F_in, D = xh.shape[0] // x.shape[0], xh.shape[1]
    r = x.repeat_interleave(F_in, dim=0) - xh
    tab = w.table.float()[ids.long()]
    ccb = _mm(rnd(xh), w.w2.float()) + w.concat_b
    h_cand = _mm(tab[..., :D], w.wfold.float()) if w.wfold is not None else tab[..., D:]
    h = rnd(h_cand + ccb[:, None, :])
    for l in range(spec.L):
        up = rnd(torch.relu(_mm(h, w.ffn_up[l].float())))
        h = rnd(h + rnd(_mm(up, w.ffn_down[l].float())))
    out = _mm(h, w.out_proj.float()) if w.out_proj is not None else h
    diff = r[:, None, :].double() - out.double()
    if spec.res_codeword_coeff:
        diff = diff - tab[..., :D].double()
    return (diff * diff).sum(-1).float()
