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
- :func:`fused_cut` replaces the bodies that ``kernel_variants.py``'s
  ``run_variant`` hands to its ``pallas_call`` (:182): B4
  (:func:`kernels.fused_substep_scores`) cut after its binned argmin
  (``sel``, ``sel_kernel`` :118: the packed bin minima), after fetching
  each winner's row of the table :func:`variant_table` (``sel+fetch``,
  ``sel_fetch_kernel`` :123, and ``fetchb`` :848, its alias: sum(row^2) a
  slot), with the bin minimum replaced by the float sum of the bin's
  packed values (``dsub`` :756), or on the script's stand-in MLP chain
  (:func:`stand_in_weights`): on T's row 0 for every slot without
  selection or fetch (``mlponly`` :886, unpacked), or after B4's selection
  and fetch in bf16 (``fullopt`` :198).
- :func:`selcat` replaces ``selcat_kernel`` (:638, ``pallas_call`` :727):
  B2' with external vals on the folded table, the distance formed from x
  and xh (:func:`selcat_plain` says where its rounding differs from B2').
- :func:`stream_probe` replaces ``noop_kernel`` (:782, ``pallas_call``
  :182) and ``bwk`` (:804, ``pallas_call`` :810): 2·xh[:, :A], and each
  tile's column sums of xh (f32 or bf16) on 8 rows.

``perbin_kernel`` (:275, ``pallas_call`` :371) and ``sgfetch_kernel`` (:388,
``pallas_call`` :500) compute production B4's function through TPU layouts
of its fetch (per-bin products, a block-diagonal table): on the card they
are :func:`kernels.fused_substep_scores` itself, which gathers by id.

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel (``csrc/ktopa_variants.cu``, ``csrc/fused_cuts.cu``: the
production kernels' templates at each cut; ``csrc/stream_probes.cu``) for
a CUDA tensor, with no fallback, and counts the launch in
:data:`kernels.LAUNCHES` under ``ktopa_variant:<mode>`` (``full`` for its
aliases), ``fused_cut:<cut>`` (``sel+fetch`` for ``fetchb``), ``selcat``
or ``stream_probe:<kind>`` (``noop``, ``bw_f32``, ``bw_bf16``).
``nodist``'s signed sum is held against :func:`nodist_exact`, ``mlponly``
against :func:`mlponly_exact`.  ``rows`` sets the beam rows of a work item
(a power of 2 up to 32; default the launch plan's), or of a streaming
probe's block (any count).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.spec import QincoSpec
from . import kernels
from .kernels import (
    FUSED_ALIASES,
    FUSED_CUTS,
    KTOPA_ALIASES,
    KTOPA_MODES,
    pack_ids_f32,
    unpack_ids,
)

# ktopa_variant's kernels (and selcat) -> the kernel's cut (csrc/selected_tc.cuh SelCut)
_SEL_CUT = {"full": 0, "noextract": 1, "mlponly": 2, "nodist": 3, "shell": 4, "perslot": 5,
            "tournament": 6, "selcat": 7}
# fused_cut's kernels -> the kernel's cut (csrc/fused_tc.cuh FusedCut)
_FUSED_CUT = {"sel": 1, "sel+fetch": 2, "dsub": 3, "mlponly": 4, "fullopt": 5}
_ONE_FETCH = ("mlponly", "nodist", "shell")
_STAND_IN = ("mlponly", "fullopt")  # fused_cut's cuts on the stand-in chain


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
    return _variant_plain(spec, x, xh, kernels.selected_weights(spec, p), n_codes, F_in, mode)


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
    w = kernels.selected_weights(spec, p)
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
               device, clustered: bool = False) -> kernels.LaunchPlan:
    """``plan`` with ``rows`` beam rows a work item, or ``plan`` itself for
    None (``clustered``: B2's kernel, on the grid of ``kernels.wg_grid``);
    raises where the kernels do not take ``rows``."""
    if rows is None:
        return plan
    if not 1 <= rows <= kernels._ROWS or rows & (rows - 1):
        raise ValueError(f"rows a work item must be a power of 2 <= {kernels._ROWS}, got {rows}")
    smem = smem_of(rows, plan.tm)
    if smem > kernels._SMEM_LIMIT:
        raise ValueError(f"{rows} rows a work item need {smem} B of shared memory "
                         f"> {kernels._SMEM_LIMIT}")
    items = -(-n // rows)
    sms = kernels.sm_count(device)
    if not clustered:
        return plan._replace(per_item=rows, smem=smem, items=items, blocks=min(items, sms))
    cluster, blocks = kernels.wg_grid(items, sms)
    return plan._replace(per_item=rows, smem=smem, items=items, blocks=blocks, cluster=cluster)


def ktopa_plan(spec: QincoSpec, xh: torch.Tensor, p, n_codes: int,
               rows: Optional[int] = None) -> kernels.LaunchPlan:
    """The launch plan of :func:`ktopa_variant` on ``xh``'s card: B2's
    (``selected_plan``), with ``rows`` beam rows a work item if given."""
    return _ktopa_plan(xh, kernels.selected_weights(spec, p), spec.L, n_codes, rows)


def _ktopa_plan(xh, w, L: int, n_codes: int, rows: Optional[int]) -> kernels.LaunchPlan:
    NF, D = xh.shape
    K = w.table.shape[0]
    stages = 2 + 2 * L + (w.out_proj is not None)  # W2, wfold, the FFN, [out_proj]
    plan = kernels.selected_plan(NF, n_codes, D, K, w.De, w.Dh, bf16=True, topa=True,
                                 stages=stages, sms=kernels.sm_count(xh.device))
    return _with_rows(plan, rows, NF, lambda R, tm: kernels._selected_mma_smem(
        R, tm, n_codes, D, K, w.De, w.Dh, True), xh.device, clustered=True)


def ktopa_variant(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int,
                  mode: str, rows: Optional[int] = None) -> torch.Tensor:
    """B2 with the phase cut ``mode`` on a CUDA tensor (the
    ``csrc/ktopa_variants.cu`` kernel), its plain version
    (:func:`ktopa_variant_plain`) on a CPU tensor."""
    F_in = _check_variant(spec, x, xh, p, n_codes, mode)
    if xh.device.type == "cpu":
        return _variant_plain(spec, x, xh, kernels.selected_weights(spec, p), n_codes, F_in, mode)
    kernels._require_cuda(xh)
    kernel = KTOPA_ALIASES.get(mode, mode)
    w = kernels.selected_weights(spec, p, kernel=True)
    plan = _ktopa_plan(xh, w, spec.L, n_codes, rows)
    NF, D = xh.shape
    K, Wt = w.table.shape
    out = torch.empty((NF, n_codes), dtype=torch.float32, device=xh.device)
    kernels._launch(
        "ktopa_variants", xh, [x.contiguous(), xh.contiguous(), None, *w.ptrs(), out],
        [NF, F_in, D, K, w.De, w.Dh, spec.L, n_codes, Wt, plan.tm, plan.per_item, plan.blocks,
         plan.smem, plan.cluster, kernels._res(spec), _SEL_CUT[kernel]],
        count=f"ktopa_variant:{kernel}")
    return out


# ---------------------------------------------------------------------------
# B4 cut at its phases (kernel_variants.py's run_variant bodies)
# ---------------------------------------------------------------------------


def variant_table(spec: QincoSpec, p, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``kernel_variants.py``'s table T (``run_variant`` :161-167): [C | cp |
    rnd(cp)·rnd(W1)] with cp = rnd(C)·rnd(P_in) (C without in_proj), the
    products in f32, in ``dtype`` (default the compute dtype)."""
    rnd = kernels.rounder(spec)
    C = p.codebook.float()
    cp = kernels._exact(rnd(C), rnd(p.in_proj)) if p.in_proj is not None else C
    w1 = p.concat_w[:cp.shape[1]]
    table = torch.cat([C, cp, kernels._exact(rnd(cp), rnd(w1))], dim=1)
    return table.to(dtype or kernels._compute_dtype(spec)).contiguous()


class StandIn(NamedTuple):
    """The stand-in weights of ``mlponly_kernel`` and ``fullopt_kernel``
    (the script's devices to keep a body compilable, so part of its
    function), bf16: W2 = sub_codebook[:D] (D, de), every FFN block's
    up = T[:de, :dh] and down = T[:dh, :de], W_out = sub_codebook[:de, :D]."""
    w2: torch.Tensor
    up: torch.Tensor
    down: torch.Tensor
    out: torch.Tensor


def stand_in_weights(spec: QincoSpec, p, table: torch.Tensor) -> StandIn:
    """The stand-in weights, sliced from the substep codebook and the table
    T (:func:`variant_table`) and rounded to bf16, as the script's bodies
    slice and cast them (:246-258, :903-914)."""
    D, De, Dh = spec.D, spec.De, spec.dh
    sub, T = p.sub_codebook, table
    if De != D or sub.shape[0] < D or T.shape[0] < max(De, Dh) or T.shape[1] < Dh:
        raise ValueError(f"the stand-in chain needs de == D, K >= D, de, dh and a table of "
                         f">= dh columns (D={D}, de={De}, dh={Dh}, K={T.shape[0]}, "
                         f"T {tuple(T.shape)})")
    bf = torch.bfloat16
    return StandIn(w2=sub[:D, :De].to(bf).contiguous(), up=T[:De, :Dh].to(bf).contiguous(),
                   down=T[:Dh, :De].to(bf).contiguous(), out=sub[:De, :D].to(bf).contiguous())


def _stand_in_h(spec, xh, s: StandIn, th, tw, mm=torch.matmul):
    """The stand-in chain's h after its L blocks for the fetched slices
    ``th``, ``tw`` (the table's h and w1 columns; (NF, slots, de) or a row
    to broadcast): cc = rnd(xh)·W2, h = rnd(rnd(T_h) + rnd(T_w1 + cc)), the
    L blocks on the same weights; ``mm`` sums the products."""
    rnd = kernels.rounder(spec)
    cc = mm(rnd(xh), s.w2.float())[:, None, :]  # (NF, 1, de)
    h = rnd(rnd(th) + rnd(tw + cc))
    for _ in range(spec.L):
        up = rnd(torch.relu(mm(h, s.up.float())))
        h = rnd(h + rnd(mm(up, s.down.float())))
    return h


def _check_cut(spec: QincoSpec, x, xh, p, n_codes: int, cut: str) -> int:
    if cut not in FUSED_CUTS:
        raise ValueError(f"fused_cut: cut must be one of {FUSED_CUTS}, got {cut!r}")
    _check_bf16("fused_cut", spec)
    return kernels._check_fused(spec, x, xh, p, n_codes)


def _cut_table(spec: QincoSpec, p, cut: str):
    """The cut's table: none for sel and dsub, T (bf16) for sel+fetch and
    fullopt, T in f32 for mlponly (its row 0 stays f32)."""
    if cut in ("sel", "dsub"):
        return None
    return variant_table(spec, p, torch.float32 if cut == "mlponly" else None)


def fused_cut_plain(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int,
                    cut: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_cut` (same contract), the
    function of the script's body, ``(N·F_in, n_codes)`` float32:

    - ``sel``: the packed minimum of each of the n_codes bins of K / n_codes
      contiguous codewords (B4's selection);
    - ``sel+fetch``, ``fetchb``: the sum of squares of each winner's row of
      :func:`variant_table`, unpacked;
    - ``dsub``: each bin's packed substep values summed as floats, unpacked;
    - ``mlponly``: every slot's candidate T's f32 row 0, the stand-in chain
      (:func:`stand_in_weights`), d = ||x - ((out + cand) + xh)||^2 in the
      script's order, unpacked (all slots of a row equal);
    - ``fullopt``: B4's selection, the winners' bf16 rows of T, the stand-in
      chain, d = ||r - (out + cand)||^2 packed with the winner's id."""
    F_in = _check_cut(spec, x, xh, p, n_codes, cut)
    w = kernels.fused_weights(spec, p)
    return _cut_plain(spec, x, xh, p, w, n_codes, F_in, cut, _cut_table(spec, p, cut))


def _cut_plain(spec, x, xh, p, w, A: int, F_in: int, cut: str, table) -> torch.Tensor:
    NF, K = xh.shape[0], w.table.shape[0]
    D, De = spec.D, spec.De
    xr = x.repeat_interleave(F_in, dim=0)
    r = xr - xh
    if cut == "mlponly":  # one candidate a row: T's row 0, in f32
        s = stand_in_weights(spec, p, table)
        row = table[0]
        h = _stand_in_h(spec, xh, s, row[D:D + De], row[D + De:D + 2 * De])[:, 0]
        d = ((xr - ((h @ s.out.float() + row[:D]) + xh)) ** 2).sum(-1)
        return d[:, None].expand(-1, A).contiguous()
    packed = kernels._substep_packed(spec, r, w.sub_t, w.cn2)
    if cut == "dsub":
        return packed.view(NF, A, K // A).sum(dim=2)
    vals = packed.view(NF, A, K // A).amin(dim=2)  # (NF, A) bin minima
    if cut == "sel":
        return vals
    ids = unpack_ids(vals)
    ext = table.float()[ids.long()]  # (NF, A, Wt)
    if cut in ("sel+fetch", "fetchb"):
        return (ext * ext).sum(-1)
    s = stand_in_weights(spec, p, table)
    h = _stand_in_h(spec, xh, s, ext[..., D:D + De], ext[..., D + De:D + 2 * De])
    out = h @ s.out.float() + ext[..., :D]
    return pack_ids_f32(((r[:, None, :] - out) ** 2).sum(-1), ids)


def mlponly_exact(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p,
                  n_codes: int) -> torch.Tensor:
    """``(N·F_in, n_codes)`` float32: ``mlponly``'s distances with every
    product summed in float64 (rounded at the plain version's points, as
    :func:`nodist_exact`), the last product, out + cand + xh and the
    distance in float64: the reference against which the kernel and the
    plain version are both held, since each flips bf16 roundings in its
    own places."""
    _check_cut(spec, x, xh, p, n_codes, "mlponly")
    F_in = xh.shape[0] // x.shape[0]
    D, De = spec.D, spec.De
    table = variant_table(spec, p, torch.float32)
    s = stand_in_weights(spec, p, table)
    row = table[0]
    h = _stand_in_h(spec, xh, s, row[D:D + De], row[D + De:D + 2 * De], mm=kernels._exact)[:, 0]
    out = h.double() @ s.out.double() + row[:D].double()
    xr = x.repeat_interleave(F_in, dim=0).double()
    d = ((xr - (out + xh.double())) ** 2).sum(-1).float()
    return d[:, None].expand(-1, n_codes).contiguous()


def fused_cut_plan(spec: QincoSpec, xh: torch.Tensor, p, n_codes: int,
                   rows: Optional[int] = None, cut: str = "sel") -> kernels.LaunchPlan:
    """The launch plan of :func:`fused_cut` on ``xh``'s card: B4's
    (``fused_plan``; for the stand-in cuts that of the folded layout on the
    stand-in weights), with ``rows`` beam rows a work item if given."""
    return _cut_plan(spec, xh, _cut_weights(spec, p, cut, _cut_table(spec, p, cut)), n_codes,
                     rows)


def _cut_weights(spec, p, cut: str, table) -> kernels.FusedWeights:
    """The kernel-form operands the cut's kernel takes: B4's with the cut's
    table if it has one, or for the stand-in cuts B4's folded layout over
    T with the stand-in weights as w2, ffn_up, ffn_down (one copy a block)
    and out_proj (:func:`kernels.folded_weights`)."""
    if cut not in _STAND_IN:
        w = kernels.fused_weights(spec, p, kernel=True)
        return w if table is None else w._replace(table=table)
    s = stand_in_weights(spec, p, table)
    L = spec.L
    return kernels.folded_weights(spec, p, table, s.w2, s.up.expand(L, -1, -1).contiguous(),
                                  s.down.expand(L, -1, -1).contiguous(), s.out)


def _cut_plan(spec, xh, w, n_codes: int, rows: Optional[int]) -> kernels.LaunchPlan:
    plan = kernels.fused_launch_plan(spec, xh, w, n_codes)
    NF, D = xh.shape
    K = w.table.shape[0]
    return _with_rows(plan, rows, NF, lambda R, tm: kernels._fused_mma_smem(
        R, tm, n_codes, D, K, w.De, w.Dh, w.Wc, w.layout, w.has_in_proj), xh.device)


def fused_cut(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int, cut: str,
              rows: Optional[int] = None) -> torch.Tensor:
    """B4 cut at ``cut`` on a CUDA tensor (the ``csrc/fused_cuts.cu``
    kernel), its plain version (:func:`fused_cut_plain`) on a CPU tensor."""
    F_in = _check_cut(spec, x, xh, p, n_codes, cut)
    table = _cut_table(spec, p, cut)
    if xh.device.type == "cpu":
        return _cut_plain(spec, x, xh, p, kernels.fused_weights(spec, p), n_codes, F_in, cut,
                          table)
    kernels._require_cuda(xh)
    kernel = FUSED_ALIASES.get(cut, cut)
    w = _cut_weights(spec, p, kernel, table)
    plan = _cut_plan(spec, xh, w, n_codes, rows)
    NF, D = xh.shape
    K, Wt = w.table.shape
    out = torch.empty((NF, n_codes), dtype=torch.float32, device=xh.device)
    kernels._launch(
        "fused_cuts", xh, [x.contiguous(), xh.contiguous(), *w.ptrs(), out],
        [NF, F_in, D, K, w.De, w.Dh, spec.L, n_codes, Wt, w.Wc, w.off_h, w.off_w1, w.off_up,
         plan.tm, plan.per_item, plan.blocks, plan.smem, kernels._res(spec), _FUSED_CUT[kernel]],
        count=f"fused_cut:{kernel}")
    return out


# ---------------------------------------------------------------------------
# selcat: B2' with external vals on the folded table (kernel_variants.py :638)
# ---------------------------------------------------------------------------


def _check_selcat(spec: QincoSpec, x, xh, p, vals) -> tuple[int, int]:
    _check_bf16("selcat", spec)
    if vals is None or vals.dim() != 2:
        raise ValueError("selcat: vals must be the packed (N·F_in, A) external top-A")
    A = vals.shape[1]
    return kernels._check_selected(spec, x, xh, p, A, vals), A


def selcat_plain(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p,
                 vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`selcat`: ``selcat_kernel``'s function
    on the external packed ``vals (N·F_in, A)``, ``(N·F_in, A)`` float32
    packed with the vals' ids.  The table is B2's folded one (``fast``
    off): T = rnd([C | cp + rnd(cp)·rnd(W1)]), cand = T[:D], h = rnd(T_h +
    rnd(xh)·W2 + b), the L blocks, out = h·P_out + cand, d = ||(x - out) -
    xh||^2.  Against production B2' under the script's spec (``fast``, the
    lean fetch: ``kernels.selected_scores`` with vals) two rounding points
    differ: h_cand = cp + rnd(cp)·rnd(W1) rounded once into the table
    instead of rnd(C)·rnd(P·(I + W1)) summed in f32, and the distance
    formed from x and xh instead of r = x - xh."""
    F_in, A = _check_selcat(spec, x, xh, p, vals)
    return _selcat_plain(spec, x, xh, kernels.selected_weights(spec.with_(fast=False), p), vals,
                         F_in)


def _selcat_plain(spec, x, xh, w, vals, F_in: int) -> torch.Tensor:
    D = xh.shape[1]
    ids = unpack_ids(vals)
    tab = w.table.float()[ids.long()]  # (NF, A, Wt), bf16-valued
    h = kernels._selected_h(spec, xh, w, tab)
    out = (h @ w.out_proj.float() if w.out_proj is not None else h) + tab[..., :D]
    diff = x.repeat_interleave(F_in, dim=0)[:, None, :] - out - xh[:, None, :]
    return pack_ids_f32((diff * diff).sum(-1), ids)


def selcat_plan(spec: QincoSpec, xh: torch.Tensor, p, n_codes: int,
                rows: Optional[int] = None) -> kernels.LaunchPlan:
    """The launch plan of :func:`selcat`: B2''s external-vals plan with
    (R, D) f32 more shared memory a block (xh kept in f32)."""
    return _selcat_plan(xh, kernels.selected_weights(spec.with_(fast=False), p), spec.L,
                        n_codes, rows)


def _selcat_plan(xh, w, L: int, A: int, rows: Optional[int]) -> kernels.LaunchPlan:
    NF, D = xh.shape
    K = w.table.shape[0]

    def smem(R, tm):
        return kernels._selected_mma_smem(R, tm, A, D, K, w.De, w.Dh, False,
                                          kernels._a16(4 * R * D))

    stages = 1 + 2 * L + (w.out_proj is not None)  # W2, the FFN, [out_proj]
    plan = kernels._selected_wg_plan(NF, A, D, K, w.De, w.Dh, False, stages,
                                     kernels.sm_count(xh.device), row_bytes=4 * D, name="selcat")
    return _with_rows(plan, rows, NF, smem, xh.device, clustered=True)


def selcat(spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, vals: torch.Tensor,
           rows: Optional[int] = None) -> torch.Tensor:
    """``selcat_kernel``'s function on a CUDA tensor (``SelCut::kSelCat`` of
    ``csrc/ktopa_variants.cu``), its plain version (:func:`selcat_plain`) on
    a CPU tensor."""
    F_in, A = _check_selcat(spec, x, xh, p, vals)
    folded = spec.with_(fast=False)
    if xh.device.type == "cpu":
        return _selcat_plain(spec, x, xh, kernels.selected_weights(folded, p), vals, F_in)
    kernels._require_cuda(xh)
    w = kernels.selected_weights(folded, p, kernel=True)
    plan = _selcat_plan(xh, w, spec.L, A, rows)
    NF, D = xh.shape
    K, Wt = w.table.shape
    out = torch.empty((NF, A), dtype=torch.float32, device=xh.device)
    kernels._launch(
        "ktopa_variants", xh, [x.contiguous(), xh.contiguous(), vals.contiguous(), *w.ptrs(), out],
        [NF, F_in, D, K, w.De, w.Dh, spec.L, A, Wt, plan.tm, plan.per_item, plan.blocks,
         plan.smem, plan.cluster, kernels._res(spec), _SEL_CUT["selcat"]], count="selcat")
    return out


# ---------------------------------------------------------------------------
# Streaming probes (kernel_variants.py's noop_kernel :782 and bwk :804)
# ---------------------------------------------------------------------------

STREAM_KINDS = ("noop", "bw")


def _check_probe(xh: torch.Tensor, kind: str, rows: int, n_codes: int) -> None:
    if kind not in STREAM_KINDS:
        raise ValueError(f"stream_probe: kind must be one of {STREAM_KINDS}, got {kind!r}")
    if xh.dim() != 2 or xh.shape[1] % 8 or not 8 <= xh.shape[1] <= 1024 or rows < 1:
        raise ValueError(f"stream_probe: xh (NF, D) with D a multiple of 8 up to 1024 and "
                         f"rows >= 1, got {tuple(xh.shape)}, rows={rows}")
    dtypes = (torch.float32,) if kind == "noop" else (torch.float32, torch.bfloat16)
    if xh.dtype not in dtypes:
        raise ValueError(f"stream_probe {kind}: xh must be one of {dtypes}, got {xh.dtype}")
    if kind == "noop" and (n_codes < 4 or n_codes % 4 or n_codes > xh.shape[1]):
        raise ValueError(f"stream_probe noop: n_codes a multiple of 4 up to D, got {n_codes}")


def stream_probe_plain(xh: torch.Tensor, kind: str, rows: int, n_codes: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`stream_probe`: ``noop`` 2·xh[:, :n_codes]
    (NF, n_codes); ``bw`` the f32 column sums of each tile of ``rows`` rows
    (the last tile those it has), each on 8 rows: (ceil(NF / rows)·8, D)."""
    _check_probe(xh, kind, rows, n_codes)
    if kind == "noop":
        return 2.0 * xh[:, :n_codes]
    NF, D = xh.shape
    tiles = -(-NF // rows)
    padded = torch.nn.functional.pad(xh.float(), (0, 0, 0, tiles * rows - NF))
    return padded.view(tiles, rows, D).sum(1).repeat_interleave(8, dim=0)


def stream_probe(xh: torch.Tensor, kind: str, rows: int, n_codes: int = 0) -> torch.Tensor:
    """The streaming probe ``kind`` on a CUDA tensor (``csrc/stream_probes.cu``:
    a block a tile of ``rows`` rows), its plain version
    (:func:`stream_probe_plain`) on a CPU tensor; ``n_codes`` the noop's A."""
    _check_probe(xh, kind, rows, n_codes)
    if xh.device.type == "cpu":
        return stream_probe_plain(xh, kind, rows, n_codes)
    kernels._require_cuda(xh)
    xh = xh.contiguous()
    if xh.data_ptr() % 16:
        raise ValueError("stream_probe: xh must start on a 16-byte boundary")
    NF, D = xh.shape
    bf16 = xh.dtype == torch.bfloat16
    shape = (NF, n_codes) if kind == "noop" else (-(-NF // rows) * 8, D)
    out = torch.empty(shape, dtype=torch.float32, device=xh.device)
    name = kind if kind == "noop" else f"bw_{'bf16' if bf16 else 'f32'}"
    kernels._launch("stream_probes", xh, [xh, out],
                    [NF, D, n_codes, rows, STREAM_KINDS.index(kind), int(bf16)],
                    count=f"stream_probe:{name}")
    return out
