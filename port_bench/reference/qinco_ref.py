"""The plain reference of QINCo2 (arXiv:2501.03078) in float32 PyTorch:
the IVF step-0 assignment, the exact beam-search encode, the decode, the
training losses and AdamW.  It imports nothing of the program under test.

Written from the paper's equations and the reference code's layout
(facebookresearch/Qinco, ``qinco_v2``), with weights as (in, out) so a
product is ``h @ w``:

- step 0 is the nearest centroid of the IVF book (the first on a tie);
- MLP step i maps a codeword ``c`` of its codebook, conditioned on the
  current reconstruction ``xhat``, to ``c + out_proj(h)``: ``h =
  in_proj(c)``, then the concat layer ``h + [h | xhat] @ W_cat + b``, then
  L residual blocks ``h + relu(h @ up) @ down``; ``in_proj`` and
  ``out_proj`` exist where de != D;
- the encode keeps a beam of B reconstructions; at each step every beam
  row pre-selects the A codewords of the substep codebook nearest to its
  residual (the first step out of the IVF step takes max(A, B)), runs the
  MLP on them, and the beam keeps the B candidates nearest to ``x``; the
  codes are the history of the best final beam;
- training: per-step decode MSEs plus the substep codebooks' MSEs, over
  rows and dimensions, the IVF book frozen.

Departures from the paper's code: the exact top-A and top-B keep the
lowest index on a tie (a stable sort); the substep distances and the
final distances drop the constant ``||x||^2``.  Every product takes its
inputs through ``q``: the identity here, a lower-precision rounding for
the control (``lowp.py``).  The encode runs in blocks of rows so that it
fits beside anything.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Shape:
    D: int
    K: int
    M: int
    L: int
    De: int
    Dh: int
    A: int
    B: int
    ivf_K: int

    @classmethod
    def of(cls, cfg: dict) -> "Shape":
        return cls(D=cfg["D"], K=cfg["K"], M=cfg["M"], L=cfg["L"], De=cfg["de"] or cfg["D"],
                   Dh=cfg["dh"], A=cfg["A"], B=cfg["B"], ivf_K=cfg["ivf_K"])


STEP_LEAVES = ("codebook", "sub_codebook", "concat_w", "concat_b", "ffn_up", "ffn_down",
               "in_proj", "out_proj")


def ident(t: torch.Tensor) -> torch.Tensor:
    return t


@contextlib.contextmanager
def strict_f32(tf32: bool = False):
    """float32 products in IEEE f32 (``tf32=False``) or TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def mm(a: torch.Tensor, w: torch.Tensor, q) -> torch.Tensor:
    """``a @ w`` from ``q``'s rounding of ``a`` by rows and of ``w`` by
    output columns (the scales an fp8 product can take)."""
    return q(a) @ q(w.T).T


def predict(W: dict, i: int, cand: torch.Tensor, cond: torch.Tensor, q=ident) -> torch.Tensor:
    """MLP step ``i``: codewords ``cand (..., D)`` conditioned on ``cond``
    (broadcast to ``cand``) -> predicted codewords (..., D)."""
    cond = cond.expand(cand.shape)
    h = cand if W["in_proj"] is None else mm(cand, W["in_proj"][i], q)
    h = h + mm(torch.cat([h, cond], dim=-1), W["concat_w"][i], q) + W["concat_b"][i]
    for l in range(W["ffn_up"].shape[1]):
        h = h + mm(torch.relu(mm(h, W["ffn_up"][i, l], q)), W["ffn_down"][i, l], q)
    out = h if W["out_proj"] is None else mm(h, W["out_proj"][i], q)
    return out + cand


def decode(W: dict, codes: torch.Tensor, q=ident) -> torch.Tensor:
    """codes (M+1, N) -> reconstructions (N, D) in normalized space."""
    codes = codes.long()
    xhat = W["codebook0"][codes[0]]
    for i in range(codes.shape[0] - 1):
        xhat = xhat + predict(W, i, W["codebook"][i][codes[i + 1]], xhat, q)
    return xhat


def ivf_assign(x: torch.Tensor, book: torch.Tensor, rows: int = 256) -> torch.Tensor:
    """The nearest row of ``book`` for each row of ``x`` (first on a tie)."""
    norms = (book * book).sum(-1)
    out = [torch.argmin(norms - 2.0 * (x[r:r + rows] @ book.T), dim=1)
           for r in range(0, x.shape[0], rows)]
    return torch.cat(out)


def _encode_block(W: dict, shp: Shape, x: torch.Tensor, q, ivf_tf32: bool) -> torch.Tensor:
    N, D = x.shape
    with strict_f32(ivf_tf32):
        code0 = ivf_assign(x, W["codebook0"])
    xhat = W["codebook0"][code0][:, None, :]  # (N, 1, D)
    reals, parents = [], []
    for i in range(shp.M):
        F_in = xhat.shape[1]
        n = max(shp.A, shp.B) if i == 0 else shp.A
        sub = W["sub_codebook"][i]
        resid = x[:, None, :] - xhat
        sub_d = (sub * sub).sum(-1) - 2.0 * mm(resid, sub.T, q)  # (N, F_in, K)
        top = torch.sort(sub_d, dim=-1, stable=True)[1][..., :n]  # (N, F_in, n)
        cand = W["codebook"][i][top]  # (N, F_in, n, D)
        cabs = predict(W, i, cand, xhat[:, :, None, :], q) + xhat[:, :, None, :]
        flat = cabs.reshape(N, F_in * n, D)
        d = (flat * flat).sum(-1) - 2.0 * (flat @ x[:, :, None])[..., 0]  # (N, F_in*n)
        sel = torch.sort(d, dim=1, stable=True)[1][:, :shp.B]
        reals.append(torch.gather(top.reshape(N, F_in * n), 1, sel))
        parents.append(sel // n)
        xhat = torch.gather(flat, 1, sel[..., None].expand(N, shp.B, D))
    beam = torch.zeros((N, 1), dtype=torch.long, device=x.device)
    rows = []
    for real, par in zip(reversed(reals), reversed(parents)):
        rows.append(torch.gather(real, 1, beam)[:, 0])
        beam = torch.gather(par, 1, beam)
    rows.append(code0)
    return torch.stack(rows[::-1])


@torch.no_grad()
def encode(W: dict, shp: Shape, x: torch.Tensor, q=ident, ivf_tf32: bool = False,
           rows: int = 256) -> torch.Tensor:
    """Exact beam-search encode of ``x (N, D)`` (normalized space) ->
    codes (M+1, N) int64, in blocks of ``rows`` vectors; every product in
    IEEE f32 unless ``q`` rounds its inputs and ``ivf_tf32`` takes the
    IVF product in TF32 (the control)."""
    with strict_f32():
        return torch.cat([_encode_block(W, shp, x[r:r + rows], q, ivf_tf32)
                          for r in range(0, x.shape[0], rows)], dim=1)


def train_losses(W: dict, x: torch.Tensor, codes: torch.Tensor, q=ident) -> torch.Tensor:
    """The training loss of rows ``x`` (normalized) under fixed ``codes``:
    the per-step decode MSEs plus the substep codebooks' MSEs, each a
    mean over rows and dimensions, the IVF book frozen."""
    N, D = x.shape
    codes = codes.long()
    xhat = W["codebook0"].detach()[codes[0]]
    total = 0.0
    for i in range(codes.shape[0] - 1):
        c = codes[i + 1]
        prev = xhat
        xhat = xhat + predict(W, i, W["codebook"][i][c], xhat, q)
        total = total + ((xhat - x) ** 2).sum() / (N * D)
        total = total + ((prev.detach() + W["sub_codebook"][i][c] - x) ** 2).sum() / (N * D)
    return total


class AdamW:
    """Decoupled weight decay, then Adam (Loshchilov & Hutter), on a dict of leaves."""

    def __init__(self, leaves: dict, lr: float, wd: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps, self.t = lr, wd, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}

    @torch.no_grad()
    def step(self, leaves: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in leaves.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def trainable(W: dict) -> list[str]:
    """The leaves training moves: every step leaf that is present."""
    return [k for k in STEP_LEAVES if W.get(k) is not None]


def train_steps(W: dict, shp: Shape, batches: list, lr: float, wd: float, grad_clip: float,
                q=ident, ivf_tf32: bool = False, fault=None) -> dict:
    """Steps of training from weights ``W`` (copied) on raw-space
    ``batches``: each an exact encode without gradients, the losses, their
    gradients clipped by value, and AdamW.  Returns each step's loss, the
    first step's clipped gradients and codes, and the weights after the
    last step.
    ``fault`` (None in every run of the benchmark) plants a fault of the
    tests' list in the step: ``"half"`` takes the loss over the first half
    of each batch, ``"code"`` shifts one step's codes.  ``codes`` are the
    first step's."""
    W = {k: (None if v is None else v.detach().clone()) for k, v in W.items()}
    names = trainable(W)
    opt = AdamW({k: W[k] for k in names}, lr, wd)
    losses, first_grads, first_codes = [], None, None
    for xb in batches:
        x = (xb - W["data_mean"]) / W["data_std"]
        codes = encode(W, shp, x, q, ivf_tf32)
        if fault == "code":
            codes = codes.clone()
            codes[2] = (codes[2] + 1) % shp.K
        step_codes = codes
        if fault == "half":
            x, codes = x[: len(x) // 2], codes[:, : len(x) // 2]
        for k in names:
            W[k].requires_grad_(True)
        with strict_f32():
            loss = train_losses(W, x, codes, q)
            grads = torch.autograd.grad(loss, [W[k] for k in names])
        for k in names:
            W[k].requires_grad_(False)
        grads = {k: g.clamp(-grad_clip, grad_clip) for k, g in zip(names, grads)}
        if first_grads is None:
            first_grads, first_codes = grads, step_codes
        with strict_f32():
            opt.step({k: W[k] for k in names}, grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first_grads, "codes": first_codes,
            "weights": {k: W[k] for k in names}}
