"""Phase-breakdown kernels of the two scoring kernels, with their plain
PyTorch versions: the card's counterparts of the TPU kernels of
``scripts/ktopa_breakdown.py`` and ``scripts/kernel_variants.py``.

- :func:`ktopa_variant` replaces ``ktopa_breakdown.py``'s ``ktopa_kernel``
  (:104, ``pallas_call`` :335): B2 (:func:`kernels.selected_scores`, the
  in-kernel exact top-A with the lean fetch, bf16) with one of the modes
  of :data:`kernels.KTOPA_MODES`, which cut or reorder its phases:

  - ``full``, ``deferred``, ``perslot``, ``catfetch``, ``tournament``:
    B2's function.  On the card ``full`` is the production kernel, and
    ``deferred`` and ``catfetch`` launch it too, counted as ``full``
    (:data:`kernels.KTOPA_ALIASES`: the TPU's deferred and catfetch only
    move where its one-hot fetch masks are built and how many products
    fetch; the card gathers by id after a complete extraction); ``perslot`` takes
    the (row, slot) pairs slot-major, one slot's rows a tile;
    ``tournament`` takes the top-A from the minima of A bins of K / A
    codewords, re-scanning only the winner's bin.  The plain versions
    select by sort (full), by A rounds of min-and-remove (deferred,
    perslot), the same with a one-hot product as the fetch (catfetch) or
    by bins (tournament): the same bits.
  - ``noextract``: slot a takes codeword a's packed substep value (no
    min-and-remove); fetch, MLP and distance as B2.
  - ``mlponly``: ``noextract`` with every slot's candidate its row's slot-0
    codeword (codeword 0), ids still 0 .. A-1.
  - ``nodist``: ``mlponly`` with d = |sum over features of (out + cand)|
    + 1 in place of the distance.
  - ``shell``: ``mlponly`` without the MLP: d = ||r - cand||^2 (on the
    card the condition product, once a row, is still computed).

  So on one card: extraction = full - noextract, fetch = noextract -
  mlponly, distance epilogue = mlponly - nodist, MLP = nodist - shell.
- :func:`fused_cut` replaces ``kernel_variants.py``'s ``sel_kernel``
  (:118) and ``sel_fetch_kernel`` (:123), ``pallas_call`` :182: B4
  (:func:`kernels.fused_substep_scores`) cut after its binned argmin
  (``sel``: the packed bin minima) or after fetching each winner's row of
  the table :func:`variant_table` (``sel+fetch``: sum(row^2) a slot).

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel (``csrc/ktopa_variants.cu``, ``csrc/fused_cuts.cu``: the
production kernels' templates at each cut) for a CUDA tensor, with no
fallback, and counts the launch in :data:`kernels.LAUNCHES` under
``ktopa_variant:<mode>`` (``full`` for its aliases) or ``fused_cut:<cut>``.
``nodist``'s signed sum is held against :func:`nodist_exact`.  ``rows`` sets the beam
rows of a work item (a power of 2 up to 32; default the launch plan's).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.spec import QincoSpec
from . import kernels
from .kernels import FUSED_CUTS, KTOPA_ALIASES, KTOPA_MODES, pack_ids_f32, unpack_ids

# ktopa_variant's kernels -> the kernel's cut (csrc/selected_tc.cuh SelCut)
_SEL_CUT = {"full": 0, "noextract": 1, "mlponly": 2, "nodist": 3, "shell": 4, "perslot": 5,
            "tournament": 6}
# fused_cut's cuts -> the kernel's cut (csrc/fused_tc.cuh FusedCut)
_FUSED_CUT = {"sel": 1, "sel+fetch": 2}
_ONE_FETCH = ("mlponly", "nodist", "shell")


def _check_bf16(name: str, spec: QincoSpec) -> None:
    if kernels._compute_dtype(spec) != torch.bfloat16:
        raise ValueError(f"{name}: the breakdown kernels run at bfloat16, got {spec.compute_dtype}")


def _check_variant(spec: QincoSpec, x, xh, p, n_codes: int, mode: str) -> int:
    if mode not in KTOPA_MODES:
        raise ValueError(f"ktopa_variant: mode must be one of {KTOPA_MODES}, got {mode!r}")
    _check_bf16("ktopa_variant", spec)
    if not spec.fast:
        raise ValueError("ktopa_variant: the lean fetch (spec.fast) only, as ktopa_breakdown.py")
    F_in = kernels._check_selected(spec, x, xh, p, n_codes, None)
    K = p.codebook.shape[0]
    if mode == "tournament" and (K % n_codes or n_codes > 32 or K // n_codes > 32):
        raise ValueError(f"tournament needs A | K with A and K / A <= 32 (K={K}, A={n_codes})")
    return F_in


def _rounds(packed: torch.Tensor, A: int) -> torch.Tensor:
    """The A smallest of each row by A rounds of min-and-remove."""
    cur, out = packed.clone(), []
    for _ in range(A):
        m = cur.amin(dim=1, keepdim=True)
        out.append(m)
        cur = torch.where(cur == m, torch.inf, cur)
    return torch.cat(out, dim=1)


def _tournament(packed: torch.Tensor, A: int) -> torch.Tensor:
    """The A smallest of each row from the minima of A bins of K / A: each
    round takes the least bin minimum and re-scans the winner's bin."""
    NF, K = packed.shape
    rows = torch.arange(NF, device=packed.device)
    bins = packed.reshape(NF, A, K // A).clone()
    best = bins.amin(dim=2)  # (NF, A)
    out = []
    for _ in range(A):
        m, w = best.min(dim=1)
        out.append(m[:, None])
        win = bins[rows, w]
        win = torch.where(win == m[:, None], torch.inf, win)
        bins[rows, w] = win
        best[rows, w] = win.amin(dim=1)
    return torch.cat(out, dim=1)


def ktopa_variant_plain(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int,
                        mode: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`ktopa_variant` (same contract):
    ``x (N, D)`` one target per vector, ``xh (N·F_in, D)`` the beam rows,
    ``p`` the step's weights.  Returns ``(N·F_in, n_codes)`` float32
    packed with each slot's id."""
    F_in = _check_variant(spec, x, xh, p, n_codes, mode)
    return _variant_plain(spec, x, xh, kernels._selected_weights(spec, p), n_codes, F_in, mode)


def nodist_exact(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p,
                 n_codes: int) -> torch.Tensor:
    """``(N·F_in, n_codes)`` float32: ``nodist``'s |sum(out + cand)| + 1
    (unpacked) with every product and the sum over features summed in
    float64, rounded at the plain version's points.  The kernel and the
    plain version each flip bf16 roundings in their own places, and the
    signed sum does not damp a flip as the distance's squares do, so the
    comparisons hold both against these sums (as ``tests/torch_exact.py``
    does for select-rebuild)."""
    F_in = _check_variant(spec, x, xh, p, n_codes, "nodist")
    w = kernels._selected_weights(spec, p)
    rnd, mm = kernels.rounder(spec), kernels._exact
    D = xh.shape[1]
    row = w.table.float()[0]  # every slot's candidate: codeword 0
    ccb = mm(rnd(xh), w.w2.float()) + w.concat_b  # (NF, De)
    h_cand = mm(row[None, :D], w.wfold.float()) if w.wfold is not None else row[None, D:]
    h = rnd(h_cand + ccb)
    for l in range(spec.L):
        up = rnd(torch.relu(mm(h, w.ffn_up[l].float())))
        h = rnd(h + rnd(mm(up, w.ffn_down[l].float())))
    out = mm(h, w.out_proj.float()) if w.out_proj is not None else h
    if spec.res_codeword_coeff:
        out = out + row[:D]
    d = out.double().sum(-1).abs().float() + 1.0
    return d[:, None].expand(-1, n_codes).contiguous()


def _variant_plain(spec, x, xh, w, A: int, F_in: int, mode: str):
    if mode == "full":
        return kernels._selected_scores_plain(spec, x, xh, w, A, F_in, None)
    D = xh.shape[1]
    r = x.repeat_interleave(F_in, dim=0) - xh  # (NF, D) residual target
    packed = kernels._substep_packed(spec, r, w.sub_t, w.cn2)  # (NF, K)
    if mode == "tournament":
        vals = _tournament(packed, A)
    elif mode in ("deferred", "perslot", "catfetch"):
        vals = _rounds(packed, A)
    else:  # no extraction: slot a takes codeword a
        vals = packed[:, :A]
    ids = unpack_ids(vals)  # (NF, A)
    fetch = ids[:, :1].expand(-1, A) if mode in _ONE_FETCH else ids
    table = w.table.float()
    if mode == "catfetch":  # the fetch as one product of one-hot rows: an exact gather
        tab = F.one_hot(fetch.long(), table.shape[0]).float() @ table
    else:
        tab = table[fetch.long()]  # (NF, A, Wt), dt-valued
    cand = tab[..., :D]
    if mode == "shell":
        diff = r[:, None, :] - cand
        return pack_ids_f32((diff * diff).sum(-1), ids)
    h = kernels._selected_h(spec, xh, w, tab)
    if mode == "nodist":
        out = h @ w.out_proj.float() if w.out_proj is not None else h
        if spec.res_codeword_coeff:
            out = out + cand
        return pack_ids_f32(out.sum(-1).abs() + 1.0, ids)
    return kernels._score(spec, h, w.out_proj, r, cand, ids)


def _with_rows(plan: kernels.LaunchPlan, rows: Optional[int], n: int, smem_of,
               device) -> kernels.LaunchPlan:
    """``plan`` with ``rows`` beam rows a work item, or ``plan`` itself for
    None; raises where the kernels do not take ``rows``."""
    if rows is None:
        return plan
    if not 1 <= rows <= kernels._ROWS or rows & (rows - 1):
        raise ValueError(f"rows a work item must be a power of 2 <= {kernels._ROWS}, got {rows}")
    smem = smem_of(rows, plan.tm)
    if smem > kernels._SMEM_LIMIT:
        raise ValueError(f"{rows} rows a work item need {smem} B of shared memory "
                         f"> {kernels._SMEM_LIMIT}")
    items = -(-n // rows)
    return plan._replace(per_item=rows, smem=smem, items=items,
                         blocks=min(items, kernels._sm_count(device)))


def ktopa_plan(spec: QincoSpec, xh: torch.Tensor, p, n_codes: int,
               rows: Optional[int] = None) -> kernels.LaunchPlan:
    """The launch plan of :func:`ktopa_variant` on ``xh``'s card: B2's
    (``selected_plan``), with ``rows`` beam rows a work item if given."""
    return _ktopa_plan(xh, kernels._selected_weights(spec, p), spec.L, n_codes, rows)


def _ktopa_plan(xh, w, L: int, n_codes: int, rows: Optional[int]) -> kernels.LaunchPlan:
    NF, D = xh.shape
    K = w.table.shape[0]
    De, Dh = w.w2.shape[1], w.ffn_up.shape[2]
    stages = 2 + 2 * L + (w.out_proj is not None)  # W2, wfold, the FFN, [out_proj]
    plan = kernels.selected_plan(NF, n_codes, D, K, De, Dh, bf16=True, topa=True, stages=stages,
                                 sms=kernels._sm_count(xh.device))
    return _with_rows(plan, rows, NF,
                      lambda R, tm: kernels._selected_mma_smem(R, tm, n_codes, D, K, De, Dh, True),
                      xh.device)


def ktopa_variant(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int,
                  mode: str, rows: Optional[int] = None) -> torch.Tensor:
    """B2 with the phase cut ``mode`` on a CUDA tensor (the
    ``csrc/ktopa_variants.cu`` kernel), its plain version
    (:func:`ktopa_variant_plain`) on a CPU tensor."""
    F_in = _check_variant(spec, x, xh, p, n_codes, mode)
    w = kernels._selected_weights(spec, p)
    if xh.device.type == "cpu":
        return _variant_plain(spec, x, xh, w, n_codes, F_in, mode)
    kernels._require_cuda(xh)
    kernel = KTOPA_ALIASES.get(mode, mode)
    plan = _ktopa_plan(xh, w, spec.L, n_codes, rows)
    NF, D = xh.shape
    K, Wt = w.table.shape
    De, Dh = w.w2.shape[1], w.ffn_up.shape[2]
    out = torch.empty((NF, n_codes), dtype=torch.float32, device=xh.device)
    kernels._launch(
        "ktopa_variants", xh,
        [x.contiguous(), xh.contiguous(), w.sub_t, w.cn2, w.table, w.wfold, w.w2, w.concat_b,
         w.ffn_up, w.ffn_down, w.out_proj, out],
        [NF, F_in, D, K, De, Dh, spec.L, n_codes, Wt, plan.tm, plan.per_item, plan.blocks,
         plan.smem, kernels._res(spec), _SEL_CUT[kernel]], count=f"ktopa_variant:{kernel}")
    return out


# ---------------------------------------------------------------------------
# B4 cut after its selection (sel) and after the fetch (sel+fetch)
# ---------------------------------------------------------------------------


def variant_table(spec: QincoSpec, p) -> torch.Tensor:
    """``kernel_variants.py``'s table (``run_variant`` :161-167), in the
    compute dtype: [C | cp | rnd(cp)·rnd(W1)] with cp = rnd(C)·rnd(P_in)
    (C without in_proj), the products in f32."""
    rnd = kernels.rounder(spec)
    C = p.codebook.float()
    cp = kernels._exact(rnd(C), rnd(p.in_proj)) if p.in_proj is not None else C
    w1 = p.concat_w[:cp.shape[1]]
    table = torch.cat([C, cp, kernels._exact(rnd(cp), rnd(w1))], dim=1)
    return table.to(kernels._compute_dtype(spec)).contiguous()


def _check_cut(spec: QincoSpec, x, xh, p, n_codes: int, cut: str) -> int:
    if cut not in FUSED_CUTS:
        raise ValueError(f"fused_cut: cut must be one of {FUSED_CUTS}, got {cut!r}")
    _check_bf16("fused_cut", spec)
    return kernels._check_fused(spec, x, xh, p, n_codes)


def fused_cut_plain(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int,
                    cut: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_cut` (same contract).
    ``sel``: ``(N·F_in, n_codes)`` the packed minimum of each of the
    n_codes bins of K / n_codes contiguous codewords (B4's selection);
    ``sel+fetch``: the sum of squares of each winner's row of
    :func:`variant_table`, float32 unpacked."""
    F_in = _check_cut(spec, x, xh, p, n_codes, cut)
    w = kernels._fused_weights(spec, p)
    table = variant_table(spec, p) if cut == "sel+fetch" else None
    return _cut_plain(spec, x, xh, w, n_codes, F_in, table)


def _cut_plain(spec, x, xh, w, A: int, F_in: int, table) -> torch.Tensor:
    NF, K = xh.shape[0], w.table.shape[0]
    r = x.repeat_interleave(F_in, dim=0) - xh
    packed = kernels._substep_packed(spec, r, w.sub_t, w.cn2)
    vals = packed.view(NF, A, K // A).amin(dim=2)  # (NF, A) bin minima
    if table is None:
        return vals
    ext = table.float()[unpack_ids(vals).long()]  # (NF, A, Wt)
    return (ext * ext).sum(-1)


def fused_cut_plan(spec: QincoSpec, xh: torch.Tensor, p, n_codes: int,
                   rows: Optional[int] = None) -> kernels.LaunchPlan:
    """The launch plan of :func:`fused_cut` on ``xh``'s card: B4's
    (``fused_plan``), with ``rows`` beam rows a work item if given."""
    w = kernels._pad_fused_rank(kernels._fused_weights(spec, p))
    return _cut_plan(spec, xh, w, n_codes, p.in_proj is not None, rows)


def _cut_plan(spec, xh, w, n_codes: int, in_proj: bool, rows: Optional[int]) -> kernels.LaunchPlan:
    plan = kernels._fused_launch_plan(spec, xh, w, n_codes, in_proj)
    NF, D = xh.shape
    K = w.table.shape[0]
    Wc, De, Dh = w.w2.shape[1], w.ffn_up.shape[1], w.ffn_up.shape[2]
    return _with_rows(plan, rows, NF,
                      lambda R, tm: kernels._fused_mma_smem(R, tm, n_codes, D, K, De, Dh, Wc,
                                                            kernels._fused_layout(w), in_proj),
                      xh.device)


def fused_cut(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int, cut: str,
              rows: Optional[int] = None) -> torch.Tensor:
    """B4 cut at ``cut`` on a CUDA tensor (the ``csrc/fused_cuts.cu``
    kernel), its plain version (:func:`fused_cut_plain`) on a CPU tensor."""
    F_in = _check_cut(spec, x, xh, p, n_codes, cut)
    w = kernels._fused_weights(spec, p)
    table = variant_table(spec, p) if cut == "sel+fetch" else None
    if xh.device.type == "cpu":
        return _cut_plain(spec, x, xh, w, n_codes, F_in, table)
    kernels._require_cuda(xh)
    w = kernels._pad_fused_rank(w)
    plan = _cut_plan(spec, xh, w, n_codes, p.in_proj is not None, rows)
    NF, D = xh.shape
    K = w.table.shape[0]
    table = w.table if table is None else table
    Wc, De, Dh = w.w2.shape[1], w.ffn_up.shape[1], w.ffn_up.shape[2]
    out = torch.empty((NF, n_codes), dtype=torch.float32, device=xh.device)
    kernels._launch(
        "fused_cuts", xh,
        [x.contiguous(), xh.contiguous(), w.sub_t, w.cn2, table, w.w2, w.concat_w2, w.concat_b,
         w.ffn_up, w.ffn_down, w.out_proj, out],
        [NF, F_in, D, K, De, Dh, spec.L, n_codes, table.shape[1], Wc, w.off_h, w.off_w1,
         w.off_up, plan.tm, plan.per_item, plan.blocks, plan.smem, kernels._res(spec),
         _FUSED_CUT[cut]], count=f"fused_cut:{cut}")
    return out
