"""The numbers that decide ``correct``: what the program returned, held
against the plain reference (``reference/``), which works out again
everything the program derived.  Nothing here imports the program.

Encode cells (``encode_readings``): for a sample of the vectors the
window encoded, the reference's exact f32 encode, and the decodes of both
codes in f32:

- ``code_disagreement``: the share of codes (IVF step and every MLP
  step) that differ from the reference's;
- ``mse_excess``: the MSE of the program's codes over the reference's,
  less 1.

Training cells (``train_readings``): the first three steps, the program's
against the reference's from the same weights and rows:

- ``loss_gap``: the widest relative gap of a step's loss;
- ``grad_gap``: of each leaf's first gradient (clipped, as the optimizer
  gets it), the gap between the two norms over the larger of the
  reference's norm of that leaf and of the median leaf; the worst leaf;
- ``change_gap``: the same of each leaf's change over the three steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (below that a leaf moves under Adam by rounding
  alone);
- ``leaf_grad_gap``, ``leaf_change_gap``: the same two over those
  leaves, each gap over that leaf's own reference norm, so that a small
  leaf left unmoved, or moved double, reads about 1 however small it is;
- ``code_disagreement``: the share of the first step's codes (its
  encode's, which the step returns) that differ from the reference's.
"""

from __future__ import annotations

import statistics

import torch

from reference import qinco_ref

CHANGE_GRAD_FLOOR = 1e-3


def normalized(W: dict, x_raw: torch.Tensor) -> torch.Tensor:
    return (x_raw - W["data_mean"]) / W["data_std"]


def encode_readings(W: dict, shp: qinco_ref.Shape, x: torch.Tensor, codes: torch.Tensor,
                    ref: torch.Tensor) -> dict:
    """The numbers of an encode sample: ``codes (M+1, N)`` held against the
    reference's ``ref`` for normalized rows ``x (N, D)``."""
    codes = codes.long()
    ks = torch.tensor([shp.ivf_K] + [shp.K] * shp.M, device=codes.device)[:, None]
    valid = codes.shape == ref.shape and bool(((codes >= 0) & (codes < ks)).all())
    if not valid:
        return {"code_disagreement": float("inf"), "head_code_disagreement": float("inf"),
                "mse_excess": float("inf")}
    with qinco_ref.strict_f32(), torch.no_grad():
        e_p = ((x - qinco_ref.decode(W, codes)) ** 2).sum(-1)
        e_r = ((x - qinco_ref.decode(W, ref)) ** 2).sum(-1)
    return {**disagreement(codes, ref),
            "mse_excess": float(e_p.mean() / e_r.mean() - 1),
            "worst_vector_excess": float(((e_p - e_r) / e_r).max())}


def disagreement(codes: torch.Tensor, ref: torch.Tensor) -> dict:
    """The share of codes that differ from the reference's: all of them,
    the head (the IVF step and the first half of the MLP steps), and each
    step's."""
    if codes.shape != ref.shape:
        return {"code_disagreement": float("inf"), "head_code_disagreement": float("inf")}
    per_step = (codes != ref).float().mean(1)
    head = per_step[: 1 + (codes.shape[0] - 1) // 2]
    return {"code_disagreement": float(per_step.mean()),
            "head_code_disagreement": float(head.mean()),
            "step_disagreement": [round(float(v), 5) for v in per_step]}


def _norms(leaves: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def _gaps(prog: dict, ref: dict, keys: list, floor: float = 0.0) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and
    ``floor``."""
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in keys}


def _median_floored(prog: dict, ref: dict, keys: list) -> dict:
    return _gaps(prog, ref, keys, statistics.median(ref[k] for k in keys))


def train_readings(prog: dict, ref: dict, W0: dict) -> dict:
    """``prog`` and ``ref``: each step's ``losses``, the first step's
    ``grads`` (a dict by leaf name) and ``codes``, and the ``weights``
    after the last step (by leaf name); ``W0`` the weights both started
    from."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    loss_gap = max(gaps) if len(prog["losses"]) == len(ref["losses"]) else float("inf")
    g_p, g_r = _norms(prog["grads"]), _norms(ref["grads"])
    keys = sorted(g_r)
    grad = _median_floored(g_p, g_r, keys)
    med = statistics.median(g_r.values())
    moved = [k for k in keys if g_r[k] >= CHANGE_GRAD_FLOOR * med]
    d_p = _norms({k: prog["weights"][k].to(W0[k].device) - W0[k] for k in moved})
    d_r = _norms({k: ref["weights"][k].to(W0[k].device) - W0[k] for k in moved})
    change = _median_floored(d_p, d_r, moved)
    leaf_grad, leaf_change = _gaps(g_p, g_r, moved), _gaps(d_p, d_r, moved)
    codes = prog["codes"].long().to(ref["codes"].device)
    return {"first_loss_gap": gaps[0] if gaps else float("inf"), "loss_gap": loss_gap,
            "grad_gap": max(grad.values()), "median_grad_gap": statistics.median(grad.values()),
            "change_gap": max(change.values()),
            "median_change_gap": statistics.median(change.values()),
            "leaf_grad_gap": max(leaf_grad.values()),
            "leaf_change_gap": max(leaf_change.values()),
            **disagreement(codes, ref["codes"]),
            "loss_gaps": gaps, "losses": list(ref["losses"]),
            "grad_gaps": {k: round(v, 6) for k, v in grad.items()},
            "change_gaps": {k: round(v, 6) for k, v in change.items()},
            "leaf_grad_gaps": {k: round(v, 6) for k, v in leaf_grad.items()},
            "leaf_change_gaps": {k: round(v, 6) for k, v in leaf_change.items()},
            "left_out": [k for k in keys if k not in moved]}
