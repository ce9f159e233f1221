"""The beam step's hand-written Hopper kernels, their plain PyTorch
versions and their wrappers (counterpart of
``qinco_tpu/ops/pallas_kernels.py``).

- :func:`selected_scores` replaces ``selected_scores_pallas``: per beam
  row, an exact top-A of the substep codewords (taken in the kernel, or
  given as packed values from outside: the external-vals route), and
  for each winner the step MLP through the folded concat table (the lean
  fetch under ``spec.fast``) and the squared distance to the target,
  with the codeword id packed into the low 8 mantissa bits
  (:func:`pack_ids_f32`).
- :func:`fused_substep_scores` replaces ``fused_substep_scores_pallas``
  (the speed profile): a binned argmin (the best codeword of each of A
  contiguous bins) and the step MLP through the fused per-codeword table.
- :func:`candidate_scores` replaces ``candidate_scores_pallas``: the
  unfolded step MLP and the full distance for externally chosen ids, any
  K (packed only for K <= 256), low-rank concat factor included.
- :func:`select_rebuild` replaces ``select_rebuild_pallas``: the exact
  beam top-F_out over each vector's packed distances (``lax.top_k`` tie
  order), then the F_out reconstructions through the step MLP.
- :func:`nearest` takes the IVF step 0 (``ops.distances.chunked_argmin``,
  which the JAX package leaves to XLA) off its plain loop of cuBLAS
  products and row mins: each row's nearest row of an f32 book, the
  product and the first-minimum argmin in one kernel that never writes a
  distance, the book split over the card by :func:`nearest_plan` and the
  splits merged by a second launch.  It has no ``kernels.*`` span; its
  launch is the profiler record ``qinco_torch::nearest``.

Each wrapper takes its plain version for a tensor on the CPU and launches
its CUDA kernel (``qinco_torch/csrc/``) for a tensor on a CUDA device;
there is no fallback from one to the other.  The kernels are compiled by
``nvcc`` at first use (the four together; the phase-breakdown cuts of
``ops/breakdown.py`` apart, at their own first use) into
``build/qinco_torch_kernels/`` and loaded with
``ctypes``.  :data:`LAUNCHES` (the recorder's always-on launch counters,
:mod:`qinco_torch.tracing`) counts the kernel launches, and each beam-step
wrapper's CUDA path (weight operands, plan, launch) is the span
``kernels.<name>``.

Under bf16 every kernel runs its MLP products on the tensor cores.
Under float32 every kernel runs them on the CUDA cores in IEEE f32 FFMA
(TF32 would give other results), through the register-tiled stage of
``csrc/f32_tile.cuh`` (persistent blocks, the weights streamed by bulk
copies in the blocked layout of :func:`blocked`).  Each beam-step wrapper
takes its operands from one builder (:func:`selected_weights` for B2,
:func:`fused_weights` for B4, :func:`chain_weights` for B3 and B5) in the
plain form or in the form its kernel reads, which :func:`weight_form`
alone decides; each tuple carries its widths and its launch's pointer
list (``ptrs``).  :func:`selected_plan`,
:func:`fused_plan`,
:func:`candidate_plan` and :func:`rebuild_plan` work out each launch
(tile, rows or vectors per work item, shared memory, blocks) from the
shapes alone, and raise where nothing fits.  Where the data's width D
leaves no one-pass plan room, B2 and B3 at bf16 take D in column passes
(the plan's ``d_passes``): the D-wide operands of the products D -> De
(the candidate codewords, the beam rows) come into a buffer one chunk of
columns at a time, again for each pass over the product's output
columns, and the D-wide output (out_proj, with the codeword and the
target) is formed pass by pass from device memory (L2); each wrapper's
span then carries ``d_passes`` and the ``refetch_bytes`` the passes read
again.  The CPU tests
(``tests/test_torch_kernel_plan.py``) hold the plans; ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold each kernel against its plain
version on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional, TypeVar

import torch
import torch.nn.functional as F

from .. import tracing
from ..models.spec import QincoSpec

# name -> (source, pointer arguments, int arguments) of the C entry point
# ``qt_<name>(pointers..., ints..., stream)``.
_KERNELS = {
    "selected_scores": ("selected_scores.cu", 13, 17),
    "select_rebuild": ("select_rebuild.cu", 13, 18),
    "fused_substep_scores": ("fused_substep_scores.cu", 12, 19),
    "candidate_scores": ("candidate_scores.cu", 12, 15),
    # the IVF step 0's nearest-row kernel and its merge (ops/distances.py)
    "nearest": ("nearest.cu", 6, 4),
    # the phase-breakdown kernels of B2 and B4 (ops/breakdown.py)
    "ktopa_variants": ("ktopa_variants.cu", 13, 16),
    "fused_cuts": ("fused_cuts.cu", 12, 19),
    "stream_probes": ("stream_probes.cu", 2, 6),
}
# The libraries compiled together at the first use of any one of them: the
# encode's five (the beam step's four and the IVF step's), and the
# phase-breakdown kernels (ops/breakdown.py), which the encode never waits
# for.
_BUILD_GROUPS = (("selected_scores", "select_rebuild", "fused_substep_scores",
                  "candidate_scores", "nearest"),
                 ("ktopa_variants", "fused_cuts", "stream_probes"))
# The modes of scripts/ktopa_breakdown.py's ktopa_kernel and the cuts of
# scripts/kernel_variants.py that ops/breakdown.py runs on the card.
KTOPA_MODES = ("full", "noextract", "deferred", "mlponly", "nodist", "shell", "perslot",
               "catfetch", "tournament")
# deferred and catfetch move only where the TPU kernel builds its one-hot
# fetch masks and how many products fetch; the card gathers by id after a
# complete extraction, so they launch full's kernel and count as full.
KTOPA_ALIASES = {"deferred": "full", "catfetch": "full"}
KTOPA_KERNELS = tuple(m for m in KTOPA_MODES if m not in KTOPA_ALIASES)
FUSED_CUTS = ("sel", "sel+fetch", "fetchb", "dsub", "mlponly", "fullopt")
# fetchb computes sel+fetch's function by one batched one-hot product (a
# TPU layout of the fetch); the card gathers by id, so it launches
# sel+fetch's kernel and counts as sel+fetch.
FUSED_ALIASES = {"fetchb": "sel+fetch"}
FUSED_KERNELS = tuple(c for c in FUSED_CUTS if c not in FUSED_ALIASES)
# The streaming probes (ops/breakdown.py's stream_probe), by kind and input.
STREAM_PROBES = ("noop", "bw_f32", "bw_bf16")
# The IVF step's kernels (csrc/nearest.cu): the nearest-row pass, and the
# merge of its splits' partials where the book is split (nearest_plan).
NEAREST_KERNELS = ("nearest", "nearest_merge")
# Kernel launches: the four beam-step kernels and the IVF step's two by
# name, the breakdown kernels by wrapper and cut (the recorder's launch
# counter group).
LAUNCHES = tracing.LAUNCHES
LAUNCHES.update({name: 0 for name in (
    "selected_scores", "select_rebuild", "fused_substep_scores", "candidate_scores",
    *NEAREST_KERNELS,
    *(f"ktopa_variant:{m}" for m in KTOPA_KERNELS), *(f"fused_cut:{c}" for c in FUSED_KERNELS),
    "selcat", *(f"stream_probe:{k}" for k in STREAM_PROBES))})

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Dynamic shared memory a block may use on sm_90 (232,448 bytes).
_SMEM_LIMIT = 227 * 1024
_ROWS = 32  # the most beam rows of a scoring kernel's work item (kRows)
# The tensor-core kernels (csrc/tc.cuh): one block per SM, and a launch
# should offer at least one work item per SM of an H100 SXM.
_SMS = 132
_MMA_TILES = (128, 64)  # MLP row tiles, largest first
_MMA_WIDTH = 16  # every width is a multiple of the mma tile's 16
_MMA_STAGES = 64  # tc::kMaxStages: products in one weight stream
_STAGE_BYTES = _MMA_STAGES * 16  # tc::kStageBytes: the stage table
_RING_BYTES = 3 * 32 * (128 + 8) * 2  # tc::kRingBytes: 3 slabs of 32 x 128 bf16, padded
# B2's bf16 kernel on wgmma (csrc/wgmma.cuh, selected_tc.cuh): tiles of 128
# or 64 pairs, weight slabs of 64 rows in column passes of 128, a ring of 4
# to 16 slabs, and clusters of _WG_CLUSTER blocks that share each slab.
_WG_TILES = (128, 64)  # pairs a tile: two consumer warpgroups, or one
_WG_SLAB_K = 64  # wg::kSlabK
_WG_PASS = 128  # wg::kPass
_WG_SLAB_BYTES = _WG_SLAB_K * _WG_PASS * 2  # wg::kSlabBytes: a ring slot
_WG_RING = (4, 16)  # wg::kMinRing, wg::kMaxRing
_WG_BAR_BYTES = 2 * 16 * 8  # wg::kBarBytes
# The FFN hidden's widths, in passes of _WG_PASS, that the 128-pair tile
# holds in registers (hidden_passes in selected_tc.cuh): 64 or 96 a thread.
_WG_HIDDEN_PASSES = (2, 3)
# Blocks of a cluster where every SM has a work item: a weight byte read
# from L2 then feeds 2·tile pairs.  Clusters of 4 ran slower on an H100
# (PERF.md §6): the kernel is not bound by L2 at these tiles.
_WG_CLUSTER = 2
# The f32 kernels (csrc/f32_tile.cuh): one block per SM too.
_F32_TILES = (64, 32)  # MLP row tiles, largest first
_F32_PASS = 128  # f32::kPass: output columns of a pass, the blocked layout's width
_F32_STAGES = 64  # f32::kMaxStages
_F32_STAGE_BYTES = _F32_STAGES * 24  # f32::kStageBytes
_F32_RING_BYTES = 64 + 3 * 32 * 128 * 4  # f32::kRingBytes: barriers, 3 slabs of 32 x 128 f32
_F32_SLOTS = 32  # f32::kSlots: distance partials a tile row


def _compute_dtype(spec: QincoSpec) -> torch.dtype:
    dt = getattr(torch, spec.compute_dtype, None)
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {spec.compute_dtype!r}")
    return dt


def rounder(spec: QincoSpec):
    """``t -> t`` rounded to ``spec.compute_dtype`` and held as float32:
    a product of two rounded operands in float32 is the bf16-in /
    f32-accumulate product of the JAX package (``preferred_element_type``)."""
    if _compute_dtype(spec) == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    return lambda t: t.float()


def _exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as a float32 result summed in float64: the f32-accumulated
    product with which the JAX package builds its tables, independent of
    TF32 and of the summation order."""
    return (a.double() @ b.double()).float()


# ---------------------------------------------------------------------------
# Packed ids (B1, ``_pack_ids_f32``)
# ---------------------------------------------------------------------------


def pack_ids_f32(d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Overwrite the 8 low mantissa bits of float32 ``d`` with ``ids``
    (K <= 256).  Values with ``|d| < 1e-30`` are first pushed to ±1e-30 (a
    normal float) so that no packed value is subnormal: flush-to-zero
    would strip its id.  A subnormal ``d`` counts as zero and goes to
    +1e-30, as under the flush-to-zero arithmetic of the JAX package's
    backends (TPU, XLA on the CPU)."""
    tiny = d.new_tensor(1e-30)
    negative = d <= -torch.finfo(torch.float32).tiny  # a normal negative value
    d = torch.where(d.abs() < tiny, torch.where(negative, -tiny, tiny), d)
    di = (d.contiguous().view(torch.int32) & ~0xFF) | ids.to(torch.int32)
    return di.view(torch.float32)


def unpack_ids(v: torch.Tensor) -> torch.Tensor:
    """The ids packed by :func:`pack_ids_f32`, as int32."""
    return v.contiguous().view(torch.int32) & 0xFF


# ---------------------------------------------------------------------------
# Pieces shared by the plain versions
# ---------------------------------------------------------------------------


def _substep_operands(spec: QincoSpec, p):
    """(sub_t (D, K) the rounded substep codebook transposed, cn2 (K,) the
    squared norms of the f32 substep codebook)."""
    sub = p.sub_codebook.float()
    return rounder(spec)(sub).t().contiguous(), (sub * sub).sum(1)


def _substep_packed(spec, r, sub_t, cn2):
    """Packed substep partial distances ``(NF, K)``:
    ‖C_k‖² − 2·rnd(C_k)·rnd(r) with id k in the low bits."""
    d_sub = cn2[None, :] - 2.0 * (rounder(spec)(r) @ sub_t)
    ids = torch.arange(cn2.shape[0], dtype=torch.int32, device=r.device)[None, :]
    return pack_ids_f32(d_sub, ids)


def _ffn(spec, h, ffn_up, ffn_down, l0: int = 0):
    rnd = rounder(spec)
    for l in range(l0, spec.L):
        up = rnd(torch.relu(h @ ffn_up[l].float()))
        h = rnd(h + rnd(up @ ffn_down[l].float()))
    return h


def _score(spec, h, out_proj, r, cand, ids):
    """‖r − out − cand‖² (cand only in QINCo2 mode), packed with ``ids``."""
    out = h @ out_proj.float() if out_proj is not None else h
    diff = r[:, None, :] - out
    if spec.res_codeword_coeff:
        diff = diff - cand
    return pack_ids_f32((diff * diff).sum(-1), ids)


def _check_rows(name: str, x, xh, p) -> int:
    """x (N, D) one target per vector, xh (N·F_in, D); returns F_in."""
    NF, D = xh.shape
    if x.dim() != 2 or x.shape[1] != D or x.shape[0] == 0 or NF % x.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be (NF / F_in, D) for xh "
                         f"{tuple(xh.shape)}")
    if x.dtype != torch.float32 or xh.dtype != torch.float32:
        raise ValueError(f"{name}: x and xh must be float32")
    if x.device != xh.device or p.codebook.device != xh.device:
        raise ValueError(f"{name}: x, xh and the step weights must be on one device")
    return NF // x.shape[0]


# ---------------------------------------------------------------------------
# B2 / B2': selected scores (in-kernel or external exact top-A)
# ---------------------------------------------------------------------------


class SelectedWeights(NamedTuple):
    """B2's operands (:func:`selected_weights`; the shapes are the plain
    form's) and their widths."""
    sub_t: torch.Tensor  # (D, K) f32: substep codebook rounded, transposed
    cn2: torch.Tensor  # (K,) f32: squared norms of the f32 substep codebook
    table: torch.Tensor  # (K, Wt) dt: lean C (Wt = D) or folded [C | h_cand]
    wfold: Optional[torch.Tensor]  # (D, De) dt: P·(I+W1) with the lean table
    w2: torch.Tensor  # (D, De) dt: condition half of the concat weight
    concat_b: torch.Tensor  # (De,) f32
    ffn_up: torch.Tensor  # (L, De, Dh) dt
    ffn_down: torch.Tensor  # (L, Dh, De) dt
    out_proj: Optional[torch.Tensor]  # (De, D) dt
    De: int
    Dh: int

    # the weights a kernel streams: weight_form lays them out
    STREAMED = ("wfold", "w2", "ffn_up", "ffn_down", "out_proj")

    def ptrs(self) -> list:
        """The operands in the order of B2's C entry points
        (``selected_scores.cu``, ``ktopa_variants.cu``)."""
        return [self.sub_t, self.cn2, self.table, self.wfold, self.w2, self.concat_b, self.ffn_up,
                self.ffn_down, self.out_proj]


def selected_weights(spec: QincoSpec, p, kernel: bool = False) -> SelectedWeights:
    """The operands of ``selected_scores_pallas``.  Under ``spec.fast``
    the lean fetch: the dt codebook, multiplied into the folded weight
    wfold = P·(I+W1) (computed in high precision, as JAX's HIGHEST).
    Otherwise the folded table rnd([C | cp + rnd(cp)·rnd(W1)]) with
    cp = rnd(C)·rnd(P), or C without in_proj.  The streamed weights in the
    plain form, or with ``kernel`` in the kernel's (:func:`weight_form`)."""
    dt = _compute_dtype(spec)
    rnd = rounder(spec)
    h_w = p.in_proj.shape[1] if p.in_proj is not None else spec.D
    w1, w2 = p.concat_w[:h_w], p.concat_w[h_w:]
    C = p.codebook.float()
    wfold = None
    if spec.fast:
        wfold = torch.eye(h_w, dtype=torch.float32, device=w1.device) + w1
        if p.in_proj is not None:
            wfold = _exact(p.in_proj, wfold)
        table = C.to(dt)
    else:
        cp = _exact(rnd(C), rnd(p.in_proj)) if p.in_proj is not None else C
        table = torch.cat([C, cp + _exact(rnd(cp), rnd(w1))], dim=1).to(dt)
    sub_t, cn2 = _substep_operands(spec, p)
    De, Dh = p.ffn_up.shape[1:]
    return weight_form(SelectedWeights(
        sub_t=sub_t, cn2=cn2, table=table.contiguous(), wfold=wfold, w2=w2,
        concat_b=p.concat_b.float().contiguous(), ffn_up=p.ffn_up, ffn_down=p.ffn_down,
        out_proj=p.out_proj, De=De, Dh=Dh), dt, kernel)


def _check_selected(spec: QincoSpec, x, xh, p, n_codes: int, vals) -> int:
    K = p.codebook.shape[0]
    if K > 256:
        raise ValueError("selected_scores requires K <= 256")
    if n_codes < 1:
        raise ValueError("selected_scores requires n_codes >= 1")
    if vals is None and n_codes > K:
        # rounds beyond K would find every entry removed and fetch nothing
        raise ValueError(f"in-kernel top-A requires n_codes <= K ({n_codes} > {K})")
    if p.concat_w2 is not None:
        raise ValueError("selected_scores takes no low-rank concat factor")
    F_in = _check_rows("selected_scores", x, xh, p)
    if vals is not None and (vals.shape != (xh.shape[0], n_codes)
                             or vals.dtype != torch.float32 or vals.device != xh.device):
        raise ValueError(f"vals must be packed float32 {(xh.shape[0], n_codes)} on xh's device")
    return F_in


def selected_scores_plain(
    spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int,
    vals: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the selected-scores kernel.

    ``x (N, D)`` holds one target per vector, ``xh (N·F_in, D)`` the beam
    rows (F_in per vector), ``p`` the step's :class:`StepParams`.  The
    n_codes candidates of a row are its nearest substep codewords (exact,
    ascending, ties to the lower id), or, with ``vals (N·F_in, n_codes)``,
    the ids packed in those values (the external-vals route).  Returns
    ``(N·F_in, n_codes)`` float32: the squared distance ‖r − MLP − cand‖²
    of each candidate with its codeword id packed in."""
    F_in = _check_selected(spec, x, xh, p, n_codes, vals)
    return _selected_scores_plain(spec, x, xh, selected_weights(spec, p), n_codes, F_in, vals)


def _selected_scores_plain(spec, x, xh, w: SelectedWeights, n_codes: int, F_in: int, vals):
    D = xh.shape[1]
    r = x.repeat_interleave(F_in, dim=0) - xh  # (NF, D) residual target
    if vals is None:
        packed = _substep_packed(spec, r, w.sub_t, w.cn2)
        vals = torch.sort(packed, dim=1, stable=True).values[:, :n_codes]
    ids = unpack_ids(vals)  # (NF, A)
    tab = w.table.float()[ids.long()]  # (NF, A, Wt), dt-valued
    h = _selected_h(spec, xh, w, tab)
    return _score(spec, h, w.out_proj, r, tab[..., :D], ids)


def _selected_h(spec, xh, w: SelectedWeights, tab):
    """The step MLP's h after the FFN blocks for the fetched table rows
    ``tab (NF, A, Wt)`` of the beam rows ``xh``."""
    rnd = rounder(spec)
    D = xh.shape[1]
    ccb = rnd(xh) @ w.w2.float() + w.concat_b  # (NF, De)
    h_cand = tab[..., :D] @ w.wfold.float() if w.wfold is not None else tab[..., D:]
    return _ffn(spec, rnd(h_cand + ccb[:, None, :]), w.ffn_up, w.ffn_down)


def selected_scores(
    spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int,
    vals: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Selected-scores kernel on a CUDA tensor, its plain version
    (:func:`selected_scores_plain`, same contract) on a CPU tensor."""
    F_in = _check_selected(spec, x, xh, p, n_codes, vals)
    if xh.device.type == "cpu":
        return _selected_scores_plain(spec, x, xh, selected_weights(spec, p), n_codes, F_in,
                                      vals)
    return _selected_cuda(spec, x, xh, p, n_codes, F_in, vals)


def _selected_cuda(spec: QincoSpec, x, xh, p, n_codes: int, F_in: int, vals) -> torch.Tensor:
    """The CUDA path of :func:`selected_scores`, in its span
    ``kernels.selected_scores`` with the plan's ids; counts the bytes its
    column passes read again (``kernels.refetch_bytes``) and the launches
    that hold the FFN hidden in registers, those on 128-pair tiles
    (``kernels.selected_hidden_regs``)."""
    with tracing.span("kernels.selected_scores") as sp:
        _require_cuda(xh)
        w = selected_weights(spec, p, kernel=True)
        plan = selected_launch_plan(spec, xh, w, n_codes, vals is None)
        refetch = selected_refetch_bytes(plan, n_codes, xh.shape[1], w.De,
                                         wfold=w.wfold is not None, res=bool(_res(spec)))
        regs = plan.mma and plan.tm == _WG_TILES[0]
        sp.set(tile_pairs=plan.tm, cluster=plan.cluster, d_passes=plan.d_passes,
               refetch_bytes=refetch, hidden="regs" if regs else "smem")
        tracing.count("kernels.refetch_bytes", refetch)
        tracing.count("kernels.selected_hidden_regs", int(regs))
        return _selected_launch(spec, x, xh, w, n_codes, F_in, vals, plan)


def selected_launch_plan(spec: QincoSpec, xh, w: SelectedWeights, n_codes: int,
                         topa: bool) -> LaunchPlan:
    """:func:`selected_plan` of B2 on ``xh``'s card for the operands ``w``."""
    NF, D = xh.shape
    stages = 1 + (w.wfold is not None) + 2 * spec.L + (w.out_proj is not None)
    return selected_plan(NF, n_codes, D, w.table.shape[0], w.De, w.Dh, bf16=bool(_is_bf16(spec)),
                         topa=topa, stages=stages, sms=sm_count(xh.device))


def _selected_launch(spec: QincoSpec, x, xh, w: SelectedWeights, n_codes: int, F_in: int,
                     vals, plan: LaunchPlan) -> torch.Tensor:
    """Launch the selected-scores kernel on the kernel-form operands ``w``
    with ``plan``; returns the (NF, n_codes) output.  Counts the weight
    bytes a bf16 launch streams (``kernels.weight_stream_bytes``)."""
    NF, D = xh.shape
    K, Wt = w.table.shape
    if _is_bf16(spec):
        tracing.count("kernels.weight_stream_bytes", selected_stream_bytes(
            plan, n_codes, D, w.De, w.Dh, spec.L, wfold=w.wfold is not None,
            proj=w.out_proj is not None))
    out = torch.empty((NF, n_codes), dtype=torch.float32, device=xh.device)
    _launch("selected_scores", xh,
            [x.contiguous(), xh.contiguous(), None if vals is None else vals.contiguous(),
             *w.ptrs(), out],
            [NF, F_in, D, K, w.De, w.Dh, spec.L, n_codes, Wt, plan.tm, plan.per_item,
             plan.blocks, plan.smem, plan.cluster, d_pass_width(D, plan.d_passes),
             _is_bf16(spec), _res(spec)])
    return out


# ---------------------------------------------------------------------------
# B4: fused substep scores (binned argmin, the speed profile)
# ---------------------------------------------------------------------------


class FusedWeights(NamedTuple):
    """B4's operands (:func:`fused_weights`; the shapes are the plain
    form's) and their widths."""
    sub_t: torch.Tensor  # (D, K) f32
    cn2: torch.Tensor  # (K,) f32
    table: torch.Tensor  # (K, Wt) dt: the fused per-codeword table
    w2: torch.Tensor  # (D, Wc) dt: condition half of the concat weight
    concat_w2: Optional[torch.Tensor]  # (Wc, De) dt: the low-rank factor
    concat_b: torch.Tensor  # (De,) f32
    ffn_up: torch.Tensor  # (L, De, Dh) dt
    ffn_down: torch.Tensor  # (L, Dh, De) dt
    out_proj: Optional[torch.Tensor]  # (De, D) dt
    off_h: int  # column of the h-init slice
    off_w1: int  # column of the W1 slice (== Wt: W1 folded into the h slice)
    off_up: int  # column of the folded first up-projection (0: not folded)
    De: int
    Dh: int
    Wc: int  # the concat layer's width: De, or the low-rank factor's (padded) rank
    layout: str  # the table's: fold_up, folded or low_rank (fused_plan)
    has_in_proj: bool  # in_proj folded into the table (fused_plan)

    STREAMED = ("w2", "concat_w2", "ffn_up", "ffn_down", "out_proj")
    RANK_COLS = ("table", "w2")  # their last columns are the rank's (pad_rank)

    def ptrs(self) -> list:
        """The operands in the order of B4's C entry points
        (``fused_substep_scores.cu``, ``fused_cuts.cu``)."""
        return [self.sub_t, self.cn2, self.table, self.w2, self.concat_w2, self.concat_b,
                self.ffn_up, self.ffn_down, self.out_proj]


def fused_weights(spec: QincoSpec, p, kernel: bool = False) -> FusedWeights:
    """The operands of ``fused_substep_scores_pallas`` (:521-578): the
    table is built in f32 and rounded once to the compute dtype.

    - fold_up (the speed default): [C | h_cand | rnd(h_cand)·rnd(U_0)];
    - folded W1 (``fold_up=False``): [C | h_cand];
    - low rank (``concat_w2``): [C | cp | rnd(cp)·rnd(W1)], or
      [C | C·W1] without in_proj;

    with cp = rnd(C)·rnd(P) (C itself without in_proj) and
    h_cand = cp + rnd(cp)·rnd(W1).  The streamed weights in the plain
    form, or with ``kernel`` in the kernel's (:func:`weight_form`)."""
    dt = _compute_dtype(spec)
    rnd = rounder(spec)
    D = spec.D
    P = p.in_proj
    h_w = P.shape[1] if P is not None else D
    w1, w2 = p.concat_w[:h_w], p.concat_w[h_w:]
    C = p.codebook.float()
    cp = _exact(rnd(C), rnd(P)) if P is not None else C
    cpw1 = _exact(rnd(cp), rnd(w1))
    off_up, layout = 0, "folded"
    if p.concat_w2 is None:
        h_cand = cp + cpw1
        pieces = [C, h_cand]
        off_h, off_w1 = D, D + h_w
        if spec.L >= 1 and spec.fold_up:
            pieces.append(_exact(rnd(h_cand), rnd(p.ffn_up[0])))
            off_up, layout = off_w1, "fold_up"
    else:
        pieces = [C] + ([cp] if P is not None else []) + [cpw1]
        off_h = D if P is not None else 0
        off_w1 = D + (h_w if P is not None else 0)
        layout = "low_rank"
    sub_t, cn2 = _substep_operands(spec, p)
    De, Dh = p.ffn_up.shape[1:]
    return weight_form(FusedWeights(
        sub_t=sub_t, cn2=cn2, table=torch.cat(pieces, dim=1).to(dt).contiguous(), w2=w2,
        concat_w2=p.concat_w2, concat_b=p.concat_b.float().contiguous(), ffn_up=p.ffn_up,
        ffn_down=p.ffn_down, out_proj=p.out_proj, off_h=off_h, off_w1=off_w1, off_up=off_up,
        De=De, Dh=Dh, Wc=w2.shape[1], layout=layout, has_in_proj=P is not None), dt, kernel)


def folded_weights(spec: QincoSpec, p, table, w2, ffn_up, ffn_down, out_proj) -> FusedWeights:
    """B4's kernel-form operands in the folded layout (h slice at column D,
    no low-rank factor, a zero bias) over given ones: breakdown's stand-ins."""
    De, Dh = ffn_up.shape[1:]
    return weight_form(FusedWeights(
        *_substep_operands(spec, p), table, w2, None, torch.zeros(De, device=table.device),
        ffn_up, ffn_down, out_proj, off_h=spec.D, off_w1=spec.D + De, off_up=0, De=De, Dh=Dh,
        Wc=De, layout="folded", has_in_proj=False), _compute_dtype(spec), kernel=True)


def _check_fused(spec: QincoSpec, x, xh, p, n_codes: int) -> int:
    K, A = p.codebook.shape[0], n_codes
    if K > 256 or A < 1 or K % A or K & (K - 1) or A & (A - 1):
        raise ValueError(f"fused substep requires power-of-2 K <= 256, A | K (K={K}, A={A})")
    return _check_rows("fused_substep_scores", x, xh, p)


def fused_substep_scores_plain(
    spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int
) -> torch.Tensor:
    """Plain PyTorch version of the fused-substep kernel.

    ``x (N, D)`` one target per vector, ``xh (N·F_in, D)`` the beam rows.
    The K codewords split into n_codes contiguous bins of K/n_codes; slot
    a of a row is the float minimum of bin a's packed substep distances
    (so slots run in bin order, not ascending).  Returns ``(N·F_in,
    n_codes)`` float32: ‖r − MLP − cand‖² of each slot's winner through
    the fused table, with its id packed in.  ``spec.perbin`` selects a
    TPU layout of the same function and has no effect here."""
    F_in = _check_fused(spec, x, xh, p, n_codes)
    return _fused_substep_plain(spec, x, xh, fused_weights(spec, p), n_codes, F_in)


def _fused_substep_plain(spec, x, xh, w: FusedWeights, n_codes: int, F_in: int):
    rnd = rounder(spec)
    NF, D = xh.shape
    K, Wt = w.table.shape
    r = x.repeat_interleave(F_in, dim=0) - xh  # (NF, D) residual target
    packed = _substep_packed(spec, r, w.sub_t, w.cn2)
    vals = packed.view(NF, n_codes, K // n_codes).amin(dim=2)  # (NF, A) bin minima
    ids = unpack_ids(vals)
    tab = w.table.float()[ids.long()]  # (NF, A, Wt), dt-valued
    cand = tab[..., :D]
    cc_cond = rnd(xh) @ w.w2.float()  # (NF, Wc)
    l0 = 0
    if w.off_up:  # fold_up
        ccb = cc_cond + w.concat_b
        up_cond = rnd(ccb) @ w.ffn_up[0].float()
        h = rnd(tab[..., w.off_h:w.off_up] + ccb[:, None, :])
        up = rnd(torch.relu(tab[..., w.off_up:] + up_cond[:, None, :]))
        h = rnd(h + rnd(up @ w.ffn_down[0].float()))
        l0 = 1
    elif w.off_w1 >= Wt:  # W1 folded into the h slice
        h = rnd(tab[..., w.off_h:] + (cc_cond + w.concat_b)[:, None, :])
    else:  # low rank
        h = tab[..., w.off_h:w.off_w1] if w.off_h else cand
        lr = rnd(tab[..., w.off_w1:] + cc_cond[:, None, :])
        h = rnd(h + rnd(lr @ w.concat_w2.float() + w.concat_b))
    h = _ffn(spec, h, w.ffn_up, w.ffn_down, l0)
    return _score(spec, h, w.out_proj, r, cand, ids)


def fused_substep_scores(
    spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, p, n_codes: int
) -> torch.Tensor:
    """Fused-substep kernel on a CUDA tensor, its plain version
    (:func:`fused_substep_scores_plain`, same contract) on a CPU tensor."""
    F_in = _check_fused(spec, x, xh, p, n_codes)
    if xh.device.type == "cpu":
        return _fused_substep_plain(spec, x, xh, fused_weights(spec, p), n_codes, F_in)
    with tracing.span("kernels.fused_substep_scores"):
        _require_cuda(xh)
        w = fused_weights(spec, p, kernel=True)
        plan = fused_launch_plan(spec, xh, w, n_codes)
        return _fused_launch(spec, x, xh, w, n_codes, F_in, plan)


def fused_launch_plan(spec: QincoSpec, xh, w: FusedWeights, n_codes: int) -> LaunchPlan:
    """:func:`fused_plan` of B4 on ``xh``'s card for the operands ``w``."""
    NF, D = xh.shape
    L = spec.L
    # W2 (and U_0) once per item, then the per-tile products, [out_proj]
    stages = {"fold_up": 2 + 1 + 2 * (L - 1), "low_rank": 1 + 1 + 2 * L,
              "folded": 1 + 2 * L}[w.layout] + (w.out_proj is not None)
    return fused_plan(NF, n_codes, D, w.table.shape[0], w.De, w.Dh, w.Wc,
                      bf16=bool(_is_bf16(spec)), layout=w.layout, in_proj=w.has_in_proj,
                      stages=stages, sms=sm_count(xh.device))


def _fused_launch(spec: QincoSpec, x, xh, w: FusedWeights, n_codes: int, F_in: int,
                  plan: LaunchPlan) -> torch.Tensor:
    """Launch the fused-substep kernel on the kernel-form operands ``w``
    with ``plan``; returns the (NF, n_codes) output."""
    NF, D = xh.shape
    K, Wt = w.table.shape
    out = torch.empty((NF, n_codes), dtype=torch.float32, device=xh.device)
    _launch("fused_substep_scores", xh, [x.contiguous(), xh.contiguous(), *w.ptrs(), out],
            [NF, F_in, D, K, w.De, w.Dh, spec.L, n_codes, Wt, w.Wc, w.off_h, w.off_w1, w.off_up,
             plan.tm, plan.per_item, plan.blocks, plan.smem, _is_bf16(spec), _res(spec)])
    return out


# ---------------------------------------------------------------------------
# Weights of the unfolded step MLP (B3 and B5)
# ---------------------------------------------------------------------------


class ChainWeights(NamedTuple):
    """The unfolded step MLP's operands (:func:`chain_weights`; the shapes
    are the plain form's) and their widths."""
    in_proj: Optional[torch.Tensor]  # (D, De) dt
    concat_w: torch.Tensor  # (De + D, Wc) dt
    concat_w2: Optional[torch.Tensor]  # (Wc, De) dt
    concat_b: torch.Tensor  # (De,) f32
    ffn_up: torch.Tensor  # (L, De, Dh) dt
    ffn_down: torch.Tensor  # (L, Dh, De) dt
    out_proj: Optional[torch.Tensor]  # (De, D) dt
    De: int
    Dh: int
    Wc: int  # the concat layer's width: De, or the low-rank factor's (padded) rank
    low_rank: bool

    STREAMED = ("in_proj", "concat_w", "concat_w2", "ffn_up", "ffn_down", "out_proj")
    RANK_COLS = ("concat_w",)

    def ptrs(self) -> list:
        """The weights in the order of B3's and B5's C entry points."""
        return [self.in_proj, self.concat_w, self.concat_w2, self.concat_b, self.ffn_up,
                self.ffn_down, self.out_proj]


def chain_weights(spec: QincoSpec, p, kernel: bool = False) -> ChainWeights:
    """The step's weights for B3 and B5, in the plain form or with
    ``kernel`` in the kernel's (:func:`weight_form`)."""
    De, Dh = p.ffn_up.shape[1:]
    return weight_form(ChainWeights(
        p.in_proj, p.concat_w, p.concat_w2, p.concat_b.float().contiguous(), p.ffn_up,
        p.ffn_down, p.out_proj, De=De, Dh=Dh, Wc=p.concat_w.shape[1],
        low_rank=p.concat_w2 is not None), _compute_dtype(spec), kernel)


_Weights = TypeVar("_Weights", SelectedWeights, FusedWeights, ChainWeights)


def weight_form(w: _Weights, dt: torch.dtype, kernel: bool) -> _Weights:
    """The one place that decides the form of a step's streamed weights
    (``w.STREAMED``), from the kernel family (the tuple's type) and ``dt``.
    Plain: each cast to ``dt``, row-major.  Kernel, under bfloat16: B2's in
    the slab layout of :func:`wg_blocked`, cast in the same copy; B3's,
    B4's and B5's row-major, the low-rank rank padded (:func:`pad_rank`).
    Kernel, under float32: every kernel's in :func:`blocked`'s layout."""
    if not kernel:
        lay = lambda t: t.to(dt).contiguous()
    elif dt == torch.float32:
        lay = lambda t: blocked(t.to(dt))
    elif isinstance(w, SelectedWeights):
        lay = lambda t: wg_blocked(t, dt)
    else:
        return pad_rank(weight_form(w, dt, kernel=False))
    return w._replace(**{f: None if getattr(w, f) is None else lay(getattr(w, f))
                         for f in w.STREAMED})


def pad_rank(w: _Weights) -> _Weights:
    """B4's or the chain's operands with the low-rank factor's rank padded
    with zeros to a multiple of 16, the tensor cores' tile: zero columns at
    the end of each of ``w.RANK_COLS`` (the chain's concat_w; B4's w2 and
    table, whose W1 slice is the last), zero rows of concat_w2.  The zero
    columns give products of exactly 0, which the zero rows then add, so the
    function is unchanged."""
    if w.concat_w2 is None or not w.Wc % _MMA_WIDTH:
        return w
    pad = -w.Wc % _MMA_WIDTH
    cols = {f: F.pad(getattr(w, f), (0, pad)).contiguous() for f in w.RANK_COLS}
    return w._replace(**cols, concat_w2=F.pad(w.concat_w2, (0, 0, 0, pad)).contiguous(),
                      Wc=w.Wc + pad)


# ---------------------------------------------------------------------------
# B5: candidate scores (externally chosen ids, any K)
# ---------------------------------------------------------------------------


def _check_candidate(spec: QincoSpec, x, xh, idx, p, pack_ids: bool) -> None:
    K = p.codebook.shape[0]
    if pack_ids and K > 256:
        raise ValueError(f"candidate_scores packs ids only for K <= 256 (K={K})")
    if x.shape != xh.shape or x.dim() != 2 or x.shape[1] != spec.D:
        raise ValueError(f"x {tuple(x.shape)} and xh {tuple(xh.shape)} must both be (NF, D)")
    if idx.dim() != 2 or idx.shape[0] != xh.shape[0] or idx.dtype.is_floating_point:
        raise ValueError(f"idx {tuple(idx.shape)} must be integer (NF, A)")
    if x.dtype != torch.float32 or xh.dtype != torch.float32:
        raise ValueError("x and xh must be float32")
    if not x.device == xh.device == idx.device == p.codebook.device:
        raise ValueError("x, xh, idx and the step weights must be on one device")


def candidate_scores_plain(
    spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, idx: torch.Tensor, p,
    pack_ids: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the candidate-scores kernel.

    ``x, xh (NF, D)`` target and beam rows, ``idx (NF, A)`` codeword
    ids.  Returns ``(NF, A)`` float32 ‖x − ((MLP(cand | xh) + cand) +
    xh)‖², with cand the codeword rounded to the compute dtype (in the
    MLP and in the QINCo2 ``+ cand``), ids packed in when ``pack_ids``
    (K <= 256)."""
    from ..models.qinco import step_predict

    _check_candidate(spec, x, xh, idx, p, pack_ids)
    cand = rounder(spec)(p.codebook)[idx.long()]  # (NF, A, D), dt-valued
    diff = x[:, None, :] - (step_predict(spec, p, cand, xh) + xh[:, None, :])
    d = (diff * diff).sum(-1)
    return pack_ids_f32(d, idx) if pack_ids else d


def candidate_scores(
    spec: QincoSpec, x: torch.Tensor, xh: torch.Tensor, idx: torch.Tensor, p,
    pack_ids: bool = False,
) -> torch.Tensor:
    """Candidate-scores kernel on a CUDA tensor, its plain version
    (:func:`candidate_scores_plain`, same contract) on a CPU tensor."""
    if xh.device.type == "cpu":
        return candidate_scores_plain(spec, x, xh, idx, p, pack_ids)
    _check_candidate(spec, x, xh, idx, p, pack_ids)
    with tracing.span("kernels.candidate_scores"):
        _require_cuda(xh)
        w = chain_weights(spec, p, kernel=True)
        book = p.codebook.to(_compute_dtype(spec)).contiguous()
        plan = candidate_launch_plan(spec, xh, idx, w)
        return _candidate_launch(spec, x, xh, idx, book, w, pack_ids, plan)


def candidate_launch_plan(spec: QincoSpec, xh, idx, w: ChainWeights) -> LaunchPlan:
    """:func:`candidate_plan` of B5 on ``xh``'s card for the ids ``idx`` and
    the operands ``w``."""
    NF, A = idx.shape
    # the condition half once per item, then [in_proj], the codeword half,
    # [concat_w2], the FFN blocks, [out_proj] per tile
    stages = (1 + (w.in_proj is not None) + 1 + w.low_rank + 2 * spec.L
              + (w.out_proj is not None))
    return candidate_plan(NF, A, spec.D, w.De, w.Dh, w.Wc, bf16=bool(_is_bf16(spec)),
                          in_proj=w.in_proj is not None, low_rank=w.low_rank, stages=stages,
                          sms=sm_count(xh.device))


def _candidate_launch(spec: QincoSpec, x, xh, idx, book, w: ChainWeights, pack_ids: bool,
                      plan: LaunchPlan) -> torch.Tensor:
    """Launch the candidate-scores kernel on the kernel-form operands
    (``book`` the (K, D) codebook in the compute dtype) with ``plan``;
    returns the (NF, A) output."""
    NF, A = idx.shape
    out = torch.empty((NF, A), dtype=torch.float32, device=xh.device)
    _launch("candidate_scores", xh,
            [x.contiguous(), xh.contiguous(), idx.to(torch.int32).contiguous(), book,
             *w.ptrs(), out],
            [NF, A, spec.D, book.shape[0], w.De, w.Dh, spec.L, w.Wc, int(pack_ids), plan.tm,
             plan.per_item, plan.blocks, plan.smem, _is_bf16(spec), _res(spec)])
    return out


# ---------------------------------------------------------------------------
# B3: beam selection + rebuild
# ---------------------------------------------------------------------------


def _check_rebuild(spec: QincoSpec, dists, xh, p, A_eff: int, F_out: int) -> int:
    N, C = dists.shape
    if C % A_eff:
        raise ValueError(f"dists width {C} is not a multiple of A_eff={A_eff}")
    if F_out > C:
        raise ValueError("F_out must be <= F_in*A_eff")
    F_in = C // A_eff
    if xh.shape != (N * F_in, spec.D):
        raise ValueError(f"xh {tuple(xh.shape)} must be {(N * F_in, spec.D)}")
    if p.codebook.shape[0] > 256:
        raise ValueError("select_rebuild requires K <= 256 (packed ids)")
    if dists.dtype != torch.float32 or xh.dtype != torch.float32:
        raise ValueError("dists and xh must be float32")
    if dists.device != xh.device or p.codebook.device != xh.device:
        raise ValueError("dists, xh and the step weights must be on one device")
    return F_in


def select_rebuild_plain(
    spec: QincoSpec, dists: torch.Tensor, xh: torch.Tensor, p, A_eff: int, F_out: int
):
    """Plain PyTorch version of the select-rebuild kernel.

    ``dists (N, F_in·A_eff)`` packed (position f·A_eff + a), ``xh
    (N·F_in, D)`` f32.  Returns ``(xhat (N, F_out, D) f32, codes (N,
    F_out) int32, parents (N, F_out) int32)``, ascending; ties go to the
    lower position."""
    _check_rebuild(spec, dists, xh, p, A_eff, F_out)
    vals, sel = torch.sort(dists, dim=1, stable=True)
    vals, sel = vals[:, :F_out], sel[:, :F_out]
    parents = (sel // A_eff).int()
    codes = unpack_ids(vals)
    return rebuild_plain(spec, xh, p, codes, parents), codes, parents


def rebuild_plain(spec: QincoSpec, xh: torch.Tensor, p, codes: torch.Tensor,
                  parents: torch.Tensor) -> torch.Tensor:
    """The reconstructions of chosen (parent, code) pairs: ``xh (N·F_in,
    D)`` the beam rows, ``codes`` and ``parents (N, F_out)``.  Returns
    ``(N, F_out, D)`` f32, the parent row plus the step MLP of the f32
    codeword conditioned on it."""
    from ..models.qinco import step_predict

    N, F_out = codes.shape
    F_in, D = xh.shape[0] // N, xh.shape[1]
    rows = (torch.arange(N, device=xh.device)[:, None] * F_in + parents).reshape(-1)
    xh_sel = xh[rows]  # (N·F_out, D)
    cand = p.codebook[codes.reshape(-1).long()]
    pred = step_predict(spec, p, cand[:, None, :], xh_sel)[:, 0]
    return (pred + xh_sel).reshape(N, F_out, D)


def select_rebuild(
    spec: QincoSpec, dists: torch.Tensor, xh: torch.Tensor, p, A_eff: int, F_out: int
):
    """Select-rebuild kernel on a CUDA tensor, its plain version
    (:func:`select_rebuild_plain`, same contract) on a CPU tensor."""
    if dists.device.type == "cpu":
        return select_rebuild_plain(spec, dists, xh, p, A_eff, F_out)
    F_in = _check_rebuild(spec, dists, xh, p, A_eff, F_out)
    return _rebuild_cuda(spec, dists, xh, p, A_eff, F_out, F_in)


def _rebuild_cuda(spec: QincoSpec, dists, xh, p, A_eff: int, F_out: int, F_in: int):
    """The CUDA path of :func:`select_rebuild`, in its span
    ``kernels.select_rebuild`` with the plan's ids; counts the bytes its
    column passes read again (``kernels.refetch_bytes``)."""
    with tracing.span("kernels.select_rebuild") as sp:
        _require_cuda(xh)
        bf16 = bool(_is_bf16(spec))
        w = chain_weights(spec, p, kernel=True)
        N, C = dists.shape
        D, K = spec.D, p.codebook.shape[0]
        stages = (w.in_proj is not None) + 1 + w.low_rank + 2 * spec.L + (w.out_proj is not None)
        plan = rebuild_plan(N, C, F_out, D, w.De, w.Dh, w.Wc, bf16=bf16, low_rank=w.low_rank,
                            stages=stages, sms=sm_count(xh.device))
        refetch = rebuild_refetch_bytes(plan, F_out, D, w.De, w.Wc, in_proj=w.in_proj is not None)
        sp.set(d_passes=plan.d_passes, refetch_bytes=refetch)
        tracing.count("kernels.refetch_bytes", refetch)
        xhat = torch.empty((N, F_out, D), dtype=torch.float32, device=xh.device)
        codes = torch.empty((N, F_out), dtype=torch.int32, device=xh.device)
        parents = torch.empty((N, F_out), dtype=torch.int32, device=xh.device)
        _launch("select_rebuild", xh,
                [dists.contiguous(), xh.contiguous(), p.codebook.float().contiguous(),
                 *w.ptrs(), xhat, codes, parents],
                [N, C, A_eff, F_in, F_out, D, K, w.De, w.Dh, spec.L, w.Wc, plan.tm,
                 plan.per_item, plan.blocks, plan.smem, d_pass_width(D, plan.d_passes),
                 int(bf16), _res(spec)])
        return xhat, codes, parents


def blocked(w: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A weight ``(..., kin, nout)`` in the f32 kernels' blocked layout
    ``(..., passes, kin, 128)``, the columns past nout zero (f32::Stage):
    every 128-column pass over any run of rows is contiguous, one bulk copy
    for the kernel's weight ring."""
    if w is None:
        return None
    pad = -w.shape[-1] % _F32_PASS
    b = F.pad(w, (0, pad)).unflatten(-1, (-1, _F32_PASS))  # (..., kin, passes, 128)
    return b.transpose(-3, -2).contiguous()


# ---------------------------------------------------------------------------
# Launch plans of the four kernels
#
# Every kernel is persistent, one block per SM walking the work items; a
# work item is R beam rows (or V vectors), the most (up to 32 rows, or a
# tile's worth of vectors) that still leaves _SMS items, so that every SM
# has work; the MLP tile is the largest whose shared memory fits, then R
# (or V) shrinks until it fits.  bf16: the tensor-core kernels, the tile
# one of _MMA_TILES; where nothing fits, B2 and B3 take D in column passes
# (the fewest that fit, at a 64-pair tile).  f32: every f32 route runs on
# the register-tiled stage, the tile one of _F32_TILES.  The byte counts
# are those of the .cu files' layouts: SelectedLayout, SelectedF32Layout,
# FusedLayout, FusedF32Layout, CandidateLayout, CandidateF32Layout,
# RebuildLayout and RebuildF32Layout.
# ---------------------------------------------------------------------------


class LaunchPlan(NamedTuple):
    tm: int  # MLP row tile: (row, slot) or (vector, beam) pairs
    per_item: int  # beam rows (B2, B4, B5) or vectors (B3) per work item
    smem: int  # dynamic shared memory of a block, bytes
    items: int  # work items
    blocks: int  # blocks launched
    mma: bool  # tensor-core kernel (bf16) or CUDA-core kernel (f32)
    cluster: int = 1  # blocks of a thread-block cluster that share the weight stream (B2)
    d_passes: int = 1  # column passes over D (B2, B3): 1 holds D whole


def _ld(width: int) -> int:
    """Row stride (bf16 elements) of an activation buffer: tc::ld_of."""
    return width + 8


def _a16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _per_item(n: int, most: int) -> int:
    """The largest power of 2 <= ``most`` that leaves at least _SMS work
    items of ``n`` (1 when ``n`` is too small for that)."""
    k = 1
    while 2 * k <= most and -(-n // (2 * k)) >= _SMS:
        k *= 2
    return k


def _check_mma(stages: int, **dims: int) -> None:
    bad = {k: v for k, v in dims.items() if v % _MMA_WIDTH}
    if bad:
        raise ValueError(f"the bf16 tensor-core kernels need widths that are multiples of "
                         f"{_MMA_WIDTH}, got {bad}")
    if stages > _MMA_STAGES:
        raise ValueError(f"the step MLP has {stages} products; the tensor-core kernels "
                         f"stream at most {_MMA_STAGES}")


def _no_fit(name: str, dims: str) -> ValueError:
    return ValueError(f"{name}: no tile fits {_SMEM_LIMIT} B of shared memory ({dims})")


def _item_fit(n: int, most, smem_of, sms: int, bf16: bool) -> Optional[LaunchPlan]:
    """For each tile of the route, largest first, ``most(tm)`` rows a work
    item (fewer when that leaves fewer than _SMS items), halved until
    ``smem_of(rows, tm)`` fits; None where nothing fits.  One block per SM,
    or per item when there are fewer."""
    for tm in _MMA_TILES if bf16 else _F32_TILES:
        per = _per_item(n, most(tm))
        while per:
            smem = smem_of(per, tm)
            if smem <= _SMEM_LIMIT:
                items = -(-n // per)
                return LaunchPlan(tm, per, smem, items, min(items, sms), bf16)
            per //= 2
    return None


def _item_plan(name: str, n: int, most, smem_of, sms: int, *, bf16: bool, stages: int,
               widths: dict, dims: str) -> LaunchPlan:
    """The plan of a persistent kernel for ``n`` rows (or vectors), on the
    tensor cores (bf16: ``widths`` multiples of 16, the tiles _MMA_TILES)
    or on the f32 stage (multiples of 4, _F32_TILES), by :func:`_item_fit`;
    raises when a width or the count of products does not suit the route,
    or when nothing fits."""
    (_check_mma if bf16 else _check_f32)(stages, **widths)
    plan = _item_fit(n, most, smem_of, sms, bf16)
    if plan is None:
        raise _no_fit(name, ", ".join([f"{k}={v}" for k, v in widths.items()] + [dims]))
    return plan


def _f32_ld(width: int) -> int:
    """Row stride (floats) of an f32 activation buffer: f32::ld_of."""
    return width + 4


def _f32_ring(tm: int) -> int:
    """Bytes of the f32 weight ring for a tm-row tile (f32::ring_bytes): the
    slabs, and below 64 rows the exchange buffer of the split sums."""
    return _F32_RING_BYTES + (4 * tm * 128 if tm < 64 else 0)


def _check_f32(stages: int, **dims: int) -> None:
    _check_widths(**dims)
    if stages > _F32_STAGES:
        raise ValueError(f"the step MLP has {stages} products; the f32 kernels stream at "
                         f"most {_F32_STAGES}")


def _selected_f32_smem(R, tm, A, D, K, De, Dh, topa) -> int:
    head = (_F32_STAGE_BYTES + _a16(4 * R * D) + _a16(4 * R * De) + _a16(4 * R * A)
            + 4 * tm * _F32_SLOTS)  # r, ccb, top-A values, the distance partials
    phase0 = 4 * tm * _f32_ld(D)  # xh, the condition product's tile
    substep = 4 * K * (R + 1) if topa else 0
    tiles = 4 * tm * (_f32_ld(D) + _f32_ld(De) + _f32_ld(Dh))  # cand, h, FFN hidden
    return head + _a16(max(phase0, substep, tiles)) + _f32_ring(tm)


def _candidate_f32_smem(R, tm, A, D, De, Dh, Wc, in_proj, low_rank) -> int:
    head = (_F32_STAGE_BYTES + _a16(4 * R * D) + _a16(4 * R * Wc) + _a16(4 * R * A)
            + 4 * tm * _F32_SLOTS + 4 * R * _f32_ld(D))  # x, cc, ids, partials, xh
    h0_lr = 4 * tm * ((_f32_ld(De) if in_proj else 0) + (_f32_ld(Wc) if low_rank else 0))
    tiles = 4 * tm * (_f32_ld(D) + _f32_ld(De)) + _a16(max(h0_lr, 4 * tm * _f32_ld(Dh)))
    return head + tiles + _f32_ring(tm)


def _fused_f32_smem(R, tm, A, D, K, De, Dh, Wc, layout, in_proj) -> int:
    fold_up, low_rank = layout == "fold_up", layout == "low_rank"
    head = (_F32_STAGE_BYTES + 16 + _a16(4 * R * D) + _a16(4 * R * Wc)
            + (_a16(4 * R * Dh) if fold_up else 0) + _a16(4 * R * A)
            + 4 * tm * _F32_SLOTS)  # the fetch's barrier, r, ccb, up_cond, bin minima, partials
    phase0 = 4 * tm * (_f32_ld(D) + (_f32_ld(Wc) if fold_up else 0))  # xh, ccb: the head's A
    substep = 4 * K * (R + 1)
    # h and one buffer for h0 and lr (low rank) or up, later the FFN hidden
    h0_lr = 4 * tm * ((_f32_ld(De) if low_rank and in_proj else 0)
                      + (_f32_ld(Wc) if low_rank else 0))
    tiles = 4 * tm * _f32_ld(De) + max(h0_lr, 4 * tm * _f32_ld(Dh))
    return head + _a16(max(phase0, substep, tiles)) + _f32_ring(tm)


def _rebuild_f32_smem(V, tm, C, F_out, D, De, Dh, Wc, low_rank) -> int:
    cat = 4 * tm * max(_f32_ld(De + D), _f32_ld(Dh))  # [h0 | cond], later the FFN hidden
    h = 4 * tm * _f32_ld(max(De, D))  # cand for in_proj, later h
    lr = 4 * tm * _f32_ld(Wc) if low_rank else 0
    # the barriers, two buffers of dists, codes and parents, the tiles
    return (_F32_STAGE_BYTES + 48 + 2 * (_a16(4 * V * C) + 2 * _a16(4 * V * F_out)) + cat + h
            + lr + _f32_ring(tm))


def _pass_count(nout: int) -> int:
    """Column passes of a product of nout columns (wg::pass_count)."""
    return -(-nout // _WG_PASS)


def _k_pad(kin: int) -> int:
    """A weight's rows padded to whole slabs (wg::k_pad)."""
    return -(-kin // _WG_SLAB_K) * _WG_SLAB_K


def _wg_elems(kin: int, nout: int) -> int:
    """bf16 elements of a (kin, nout) weight in the slab layout (wg::blocked)."""
    return _k_pad(kin) * _pass_count(nout) * _WG_PASS


def wg_blocked(w: Optional[torch.Tensor], dtype: Optional[torch.dtype] = None
               ) -> Optional[torch.Tensor]:
    """A weight ``(..., kin, nout)`` in the slab layout of B2's wgmma kernel
    (``csrc/wgmma.cuh``), flat per leading index and cast to ``dtype``
    (default: its own) in the same copy: pass by pass
    (``_pass_count(nout)`` passes of 128 columns), slab by slab (64 rows),
    each slab contiguous and laid out as W^T in 8 x 8 core matrices,
    element (k, n) of the slab at ``((n // 8) * 8 + k // 8) * 64 + (n % 8)
    * 8 + k % 8``; rows past kin and columns past nout zero."""
    if w is None:
        return None
    *lead, kin, nout = w.shape
    P, Np, Kp = _pass_count(nout), _WG_PASS, _k_pad(kin)
    if (Kp, P * Np) != (kin, nout):
        w = F.pad(w, (0, P * Np - nout, 0, Kp - kin))
    n = len(lead)
    v = w.reshape(*lead, Kp // _WG_SLAB_K, _WG_SLAB_K // 8, 8, P, Np // 8, 8)  # (s, kc, kr, p, g, nr)
    v = v.permute(*range(n), n + 3, n, n + 4, n + 1, n + 5, n + 2)  # (p, s, g, kc, nr, kr)
    out = torch.empty(v.shape, dtype=dtype or w.dtype, device=w.device)
    return out.copy_(v).reshape(*lead, -1)


def _wg_tiles(Dh: int) -> tuple:
    """B2's bf16 tiles for an FFN hidden of width Dh, largest first: 128
    pairs, whose two warpgroups hold the hidden in registers, where Dh is
    one of _WG_HIDDEN_PASSES whole passes (``hidden_passes`` in
    ``csrc/selected_tc.cuh``), and 64."""
    regs = Dh % _WG_PASS == 0 and Dh // _WG_PASS in _WG_HIDDEN_PASSES
    return _WG_TILES if regs else _WG_TILES[1:]


def _selected_ring(R, tm, A, D, K, De, Dh, topa, kc: int = 0) -> int:
    """Offset of B2's weight ring in shared memory (SelectedLayout::ring):
    the barriers, r, ccb, vals and the overlaid region; ``kc`` < D: the
    columns of D a pass holds (the D-passed plan)."""
    # r, ccb, vals, the two warpgroups' distance partials
    head = _WG_BAR_BYTES + _a16(4 * R * D) + _a16(4 * R * De) + _a16(4 * R * A) + 2 * 64 * 4
    substep = _a16(4 * R * D) + 4 * K * (R + 1) if topa else 0
    if 0 < kc < D:  # a chunk of rnd(xh); h, and the FFN hidden or columns of cand
        phase0, tiles = 2 * 64 * kc, 2 * tm * (De + max(Dh, kc, _WG_PASS))
    else:  # rnd(xh), the condition product's 64 rows; cand, h, the FFN hidden at 64 pairs
        phase0, tiles = 2 * 64 * D, 2 * tm * (D + De + (Dh if tm < _WG_TILES[0] else 0))
    return -(-(head + _a16(max(phase0, substep, tiles))) // 128) * 128


def _selected_mma_smem(R, tm, A, D, K, De, Dh, topa, extra: int = 0, kc: int = 0) -> int:
    """Shared memory of B2's bf16 kernel (SelectedLayout): the ring with as
    many slots (4 to 16) as the limit leaves, and ``extra`` bytes at the
    end (selcat's f32 xh)."""
    ring = _selected_ring(R, tm, A, D, K, De, Dh, topa, kc)
    slots = max(_WG_RING[0], min(_WG_RING[1], (_SMEM_LIMIT - extra - ring) // _WG_SLAB_BYTES))
    return ring + slots * _WG_SLAB_BYTES + extra


def wg_grid(items: int, sms: int) -> tuple[int, int]:
    """(cluster, blocks) of B2's bf16 kernel for ``items`` work items: a
    cluster of _WG_CLUSTER blocks where every SM has an item, else 1;
    blocks a whole number of clusters, at most one an SM."""
    cluster = _WG_CLUSTER if items >= sms else 1
    return cluster, min(-(-items // cluster) * cluster, sms // cluster * cluster)


def _selected_wg_fit(NF, A, D, K, De, Dh, topa, sms, row_bytes: int = 0) -> Optional[LaunchPlan]:
    """B2's bf16 one-pass plan: the largest tile of :func:`_wg_tiles` whose
    rows a work item (the most that leave _SMS items, halved until it fits)
    fit with the ring's least slots (and ``row_bytes`` more a row), on the
    grid of :func:`wg_grid`; None where nothing fits."""
    for tm in _wg_tiles(Dh):
        per = _per_item(NF, _ROWS)
        while per:
            smem = _selected_mma_smem(per, tm, A, D, K, De, Dh, topa, _a16(row_bytes * per))
            if smem <= _SMEM_LIMIT:
                items = -(-NF // per)
                cluster, blocks = wg_grid(items, sms)
                return LaunchPlan(tm, per, smem, items, blocks, True, cluster)
            per //= 2
    return None


def _selected_wg_plan(NF, A, D, K, De, Dh, topa, stages, sms, row_bytes: int = 0,
                      name: str = "selected_scores") -> LaunchPlan:
    """:func:`_selected_wg_fit`, raising where nothing fits."""
    _check_mma(stages, D=D, De=De, Dh=Dh)
    plan = _selected_wg_fit(NF, A, D, K, De, Dh, topa, sms, row_bytes)
    if plan is None:
        raise _no_fit(name, f"D={D}, De={De}, Dh={Dh}, K={K}, A={A}")
    return plan


def selected_plan(NF: int, A: int, D: int, K: int, De: int, Dh: int, *, bf16: bool, topa: bool,
                  stages: int, sms: int = _SMS) -> LaunchPlan:
    """Launch plan of the selected-scores kernel for NF beam rows of A
    slots (``stages``: the step MLP's products, the condition product
    included): under bf16 the one-pass plan, or where nothing fits it the
    column passes over D; raises when no tile fits a block's shared
    memory."""
    if bf16:
        _check_mma(stages, D=D, De=De, Dh=Dh)
        plan = _selected_wg_fit(NF, A, D, K, De, Dh, topa, sms)
        if plan is None and De != D:  # the column passes form the distance in out_proj's passes
            plan = _passed_fit(D, NF, lambda tm: _ROWS, sms, lambda R, kc: _selected_mma_smem(
                R, _PASSED_TILE, A, D, K, De, Dh, topa, kc=kc), clustered=True)
        if plan is None:
            raise _no_fit("selected_scores", f"D={D}, De={De}, Dh={Dh}, K={K}, A={A}")
        return plan
    return _item_plan("selected_scores", NF, lambda tm: _ROWS,
                      lambda R, tm: _selected_f32_smem(R, tm, A, D, K, De, Dh, topa), sms,
                      bf16=False, stages=stages, widths=dict(D=D, De=De, Dh=Dh),
                      dims=f"K={K}, A={A}")


def selected_stream_bytes(plan: LaunchPlan, A: int, D: int, De: int, Dh: int, L: int, *,
                          wfold: bool, proj: bool) -> int:
    """Weight bytes a bf16 B2 launch of ``plan`` streams from L2: each work
    item's condition product once and its tiles' products once a tile, in
    the slab layout, read once for the ``plan.cluster`` blocks of a
    cluster."""
    head = _wg_elems(D, De)
    tile = ((_wg_elems(D, De) if wfold else 0) + L * (_wg_elems(De, Dh) + _wg_elems(Dh, De))
            + (_wg_elems(De, D) if proj else 0))
    tiles = -(-(plan.per_item * A) // plan.tm)
    return 2 * plan.items * (head + tiles * tile) // plan.cluster


def selected_refetch_bytes(plan: LaunchPlan, A: int, D: int, De: int, *, wfold: bool,
                           res: bool) -> int:
    """Bytes a bf16 B2 launch of ``plan`` reads again for its column passes
    over D: each work item's f32 beam rows once more for every pass over the
    condition product's output columns (De), and each tile's codewords once
    more for every pass of the lean fetch's product after the first (with
    wfold) and for the distance (with the codeword added, ``res``); 0 on the
    one-pass plan."""
    if plan.d_passes == 1:
        return 0
    head = 4 * _pass_count(De) * plan.per_item * D
    tile = 2 * plan.tm * D * ((_pass_count(De) - 1 if wfold else 0) + res)
    return plan.items * (head + -(-(plan.per_item * A) // plan.tm) * tile)


def _chain_tiles(tm, D, De, Dh, Wc, h0: bool, low_rank: bool) -> int:
    """Bytes of the per-tile bf16 buffers of B4 and B5: cand (tm, D), h
    (tm, De) and one buffer that holds h0 (tm, De) and the low-rank product
    (tm, Wc), later the FFN hidden (tm, Dh)."""
    h0_lr = (_ld(De) if h0 else 0) + (_ld(Wc) if low_rank else 0)
    return 2 * tm * (_ld(D) + _ld(De) + max(_ld(Dh), h0_lr))


def _fused_mma_smem(R, tm, A, D, K, De, Dh, Wc, layout, in_proj) -> int:
    fold_up, low_rank = layout == "fold_up", layout == "low_rank"
    head = (_STAGE_BYTES + _a16(4 * R * D) + _a16(4 * R * Wc)
            + (_a16(4 * R * Dh) if fold_up else 0) + _a16(4 * R * A)
            + 4 * tm * 16)  # r, ccb, up_cond, bin minima, the distance partials
    phase0 = 2 * _a16(R) * (_ld(D) + (_ld(Wc) if fold_up else 0))  # rnd(xh), rnd(ccb)
    substep = _a16(4 * R * D) + 4 * K * (R + 1)
    tiles = _chain_tiles(tm, D, De, Dh, Wc, low_rank and in_proj, low_rank)
    return head + _a16(max(phase0, substep, tiles)) + _RING_BYTES


_FUSED_LAYOUTS = ("fold_up", "folded", "low_rank")


def fused_plan(NF: int, A: int, D: int, K: int, De: int, Dh: int, Wc: int, *, bf16: bool,
               layout: str, in_proj: bool, stages: int, sms: int = _SMS) -> LaunchPlan:
    """Launch plan of the fused-substep kernel for NF beam rows of A bins
    (``layout``: the table's, one of fold_up, folded or low_rank; Wc: the
    concat layer's width, the padded rank with a low-rank factor;
    ``stages``: the step MLP's products, the per-row ones included); raises
    when no tile fits a block's shared memory."""
    if layout not in _FUSED_LAYOUTS:
        raise ValueError(f"layout must be one of {_FUSED_LAYOUTS}, got {layout!r}")
    smem = _fused_mma_smem if bf16 else _fused_f32_smem
    return _item_plan("fused_substep_scores", NF, lambda tm: _ROWS,
                      lambda R, tm: smem(R, tm, A, D, K, De, Dh, Wc, layout, in_proj), sms,
                      bf16=bf16, stages=stages, widths=dict(D=D, De=De, Dh=Dh, Wc=Wc),
                      dims=f"K={K}, A={A}, {layout}")


def _candidate_mma_smem(R, tm, A, D, De, Dh, Wc, in_proj, low_rank) -> int:
    head = (_STAGE_BYTES + 2 * _a16(4 * R * D) + _a16(4 * R * Wc) + _a16(4 * R * A)
            + 4 * tm * 16)  # x, xh, the condition half, ids, the distance partials
    phase0 = 2 * _a16(R) * _ld(D)  # rnd(xh)
    tiles = _chain_tiles(tm, D, De, Dh, Wc, in_proj, low_rank)
    return head + _a16(max(phase0, tiles)) + _RING_BYTES


def candidate_plan(NF: int, A: int, D: int, De: int, Dh: int, Wc: int, *, bf16: bool,
                   in_proj: bool, low_rank: bool, stages: int, sms: int = _SMS) -> LaunchPlan:
    """Launch plan of the candidate-scores kernel for NF rows of A ids (Wc:
    the concat layer's width, the padded rank with a low-rank factor;
    ``stages``: the step MLP's products, the per-row condition product
    included); raises when no tile fits a block's shared memory."""
    smem = _candidate_mma_smem if bf16 else _candidate_f32_smem
    return _item_plan("candidate_scores", NF, lambda tm: _ROWS,
                      lambda R, tm: smem(R, tm, A, D, De, Dh, Wc, in_proj, low_rank), sms,
                      bf16=bf16, stages=stages, widths=dict(D=D, De=De, Dh=Dh, Wc=Wc),
                      dims=f"A={A}")


def _rebuild_mma_smem(V, tm, C, F_out, D, De, Dh, Wc, low_rank, kc: int = 0) -> int:
    """Shared memory of B3's bf16 kernel (RebuildLayout); ``kc`` < D: the
    columns of D a pass holds (the D-passed plan)."""
    Dw = kc if 0 < kc < D else D
    cat = 2 * tm * max(_ld(De + Dw), _ld(Dh))  # [h0 | rnd(cond)], later the FFN hidden
    h = 2 * tm * _ld(max(De, Dw))  # rnd(cand) for in_proj, later h
    lr = 2 * tm * _ld(Wc) if low_rank else 0
    return (_STAGE_BYTES + _a16(4 * V * C) + 2 * _a16(4 * V * F_out) + cat + h + lr
            + _RING_BYTES)


def rebuild_plan(N: int, C: int, F_out: int, D: int, De: int, Dh: int, Wc: int, *, bf16: bool,
                 low_rank: bool, stages: int, sms: int = _SMS) -> LaunchPlan:
    """Launch plan of the select-rebuild kernel for N vectors of C packed
    distances, F_out beams out (Wc: the concat layer's width, the padded
    rank with a low-rank factor; ``stages``: the step MLP's products);
    raises when no tile fits a block's shared memory.  Under bf16, where
    nothing fits the one-pass plan, the column passes over D."""
    widths = dict(D=D, De=De, Dh=Dh, Wc=Wc)
    (_check_mma if bf16 else _check_f32)(stages, **widths)
    smem = _rebuild_mma_smem if bf16 else _rebuild_f32_smem
    most = lambda tm: max(1, tm // F_out)
    plan = _item_fit(N, most, lambda V, tm: smem(V, tm, C, F_out, D, De, Dh, Wc, low_rank), sms,
                     bf16)
    # The concat's chunks of cond start on its 32-row slabs.
    if plan is None and bf16 and De % 32 == 0:
        plan = _passed_fit(D, N, most, sms, lambda V, kc: _rebuild_mma_smem(
            V, _PASSED_TILE, C, F_out, D, De, Dh, Wc, low_rank, kc), clustered=False)
    if plan is None:
        raise _no_fit("select_rebuild", ", ".join(
            [f"{k}={v}" for k, v in widths.items()] + [f"C={C}, F_out={F_out}"]))
    return plan


def rebuild_refetch_bytes(plan: LaunchPlan, F_out: int, D: int, De: int, Wc: int, *,
                          in_proj: bool) -> int:
    """Bytes a B3 launch of ``plan`` reads again for its column passes over
    D: each pass over the output columns of in_proj (De) and of the concat
    layer (Wc) after the first reads the tile's f32 codewords or beam rows
    again; 0 on the one-pass plan."""
    if plan.d_passes == 1:
        return 0
    tile = 4 * plan.tm * D * ((_pass_count(De) - 1 if in_proj else 0) + _pass_count(Wc) - 1)
    return plan.items * -(-(plan.per_item * F_out) // plan.tm) * tile


# The D-passed plans of B2 and B3: a 64-pair tile, the chunks of D a whole
# number of 64-column slabs.
_PASSED_TILE = 64
_D_ALIGN = 64


def d_pass_width(D: int, passes: int) -> int:
    """Columns of D a pass holds when D is taken in ``passes`` column
    passes (the chunks as even as 64-column multiples allow): D itself for
    one pass."""
    return D if passes == 1 else -(-D // (_D_ALIGN * passes)) * _D_ALIGN


def _d_pass_counts(D: int):
    """The column-pass counts over D, fewest first, each with its own chunk
    width."""
    for passes in range(2, -(-D // _D_ALIGN) + 1):
        if -(-D // d_pass_width(D, passes)) == passes:
            yield passes


def _passed_fit(D: int, n: int, most, sms: int, smem_of, clustered: bool) -> Optional[LaunchPlan]:
    """The fewest column passes over D whose 64-pair tile fits, with
    ``most(tm)`` rows (or vectors) a work item halved until
    ``smem_of(per, kc)`` fits; None where none does."""
    for passes in _d_pass_counts(D):
        kc = d_pass_width(D, passes)
        per = _per_item(n, most(_PASSED_TILE))
        while per:
            smem = smem_of(per, kc)
            if smem <= _SMEM_LIMIT:
                items = -(-n // per)
                cluster, blocks = wg_grid(items, sms) if clustered else (1, min(items, sms))
                return LaunchPlan(_PASSED_TILE, per, smem, items, blocks, True, cluster, passes)
            per //= 2
    return None


# ---------------------------------------------------------------------------
# The IVF step 0: each row's nearest row of an f32 book (csrc/nearest.cu)
# ---------------------------------------------------------------------------

_NN_TILE = 128  # nn::kBM = nn::kBN: rows of x a block, book rows a tile
_NN_BLOCKS_PER_SM = 2  # __launch_bounds__(kThreads, 2)


@functools.lru_cache(maxsize=256)
def nearest_plan(N: int, K: int, sms: int = _SMS) -> int:
    """The splits of a ``K``-row book for :func:`nearest` at ``N`` rows:
    of the counts that keep the blocks (row blocks x splits) within four
    waves of the card's resident slots (two blocks an SM), the one that
    takes the fewest tile-times, waves x (tiles a split + half a tile for a
    block's start and its merge); the fewest splits on a tie.  At N = 1024,
    K = 2^20 on 132 SMs: 33 splits, 264 blocks in one wave."""
    rows, tiles = -(-N // _NN_TILE), -(-K // _NN_TILE)
    slots = _NN_BLOCKS_PER_SM * sms
    best = (float("inf"), 1)
    for splits in range(1, min(tiles, 65535, max(1, -(-4 * slots // rows))) + 1):
        cost = -(-rows * splits // slots) * (-(-tiles // splits) + 0.5)
        if cost < best[0]:
            best = (cost, splits)
    return best[1]


def nearest(x: torch.Tensor, book: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's nearest row of ``book (K, D)`` for ``x (N, D)``, float32 on
    a CUDA device: (index (N,) int64, partial distance ‖c‖² − 2 x·c (N,)
    f32), the first minimum (the lowest index among equal distances), in
    IEEE f32.  One launch of the nearest kernel, and one of its merge where
    :func:`nearest_plan` splits the book; no (N, K) tile is allocated.
    ``ops.distances.chunked_argmin_plain`` is its plain version."""
    _require_cuda(x)
    if x.dim() != 2 or book.dim() != 2 or x.shape[1] != book.shape[1] or not len(book):
        raise ValueError(f"nearest takes x (N, D) and a book (K > 0, D), got {tuple(x.shape)} "
                         f"and {tuple(book.shape)}")
    if x.dtype != torch.float32 or book.dtype != torch.float32 or book.device != x.device:
        raise ValueError(f"nearest takes float32 x and book on one device, got {x.dtype} on "
                         f"{x.device} and {book.dtype} on {book.device}")
    if x.shape[1] % 4:  # zero columns change no product and no norm
        pad = -x.shape[1] % 4
        x, book = F.pad(x, (0, pad)), F.pad(book, (0, pad))
    x, book = x.contiguous(), book.contiguous()
    (N, D), K = x.shape, book.shape[0]
    splits = nearest_plan(N, K, sm_count(x.device))
    part_d = torch.empty((splits, N), dtype=torch.float32, device=x.device)
    part_i = torch.empty((splits, N), dtype=torch.int64, device=x.device)
    if splits == 1:
        out_d, out_i = part_d[0], part_i[0]
    else:
        out_d = torch.empty((N,), dtype=torch.float32, device=x.device)
        out_i = torch.empty((N,), dtype=torch.int64, device=x.device)
    if N:
        # A profiler record of the FUNCTION scope (record_function's is the
        # user scope, to which the profiler ties no device time): the
        # profiler ties the launches' device time to it, as to an aten op's,
        # so a caller's span around chunked_argmin sees the kernels.
        with torch._C._profiler._RecordFunctionFast("qinco_torch::nearest"):
            _launch("nearest", x, [x, book, part_d, part_i, out_d, out_i], [N, K, D, splits])
        LAUNCHES["nearest_merge"] += splits > 1
    return out_i, out_d


# ---------------------------------------------------------------------------
# Build, load and launch plumbing
#
# A kernel runs on the current stream after its wrapper returns.  The
# temporaries it reads (the cast weights) may be freed by then: PyTorch's
# caching allocator gives their memory only to work queued later on the
# same stream, which runs after the kernel.
# ---------------------------------------------------------------------------


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors (or the CPU plain versions), got {t.device}")


def sm_count(device: torch.device) -> int:
    """The SMs of ``device``'s card, the plans' ``sms``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_widths(**dims: int) -> None:
    bad = {k: v for k, v in dims.items() if v % 4}
    if bad:
        raise ValueError(f"the kernels need widths that are multiples of 4, got {bad}")


def _is_bf16(spec: QincoSpec) -> int:
    return int(_compute_dtype(spec) == torch.bfloat16)


def _res(spec: QincoSpec) -> int:
    return int(bool(spec.res_codeword_coeff))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _launch(name: str, like: torch.Tensor, tensors: list, ints: list,
            count: Optional[str] = None) -> None:
    """Call ``qt_<name>`` on the current stream of ``like``'s device, with
    that device current (so the runtime's current device stays PyTorch's);
    raise on a launch error, count the launch under ``count`` (default
    ``name``)."""
    lib = _lib(name, like.device)
    with torch.cuda.device(like.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(like.device).cuda_stream)
        err = getattr(lib, f"qt_{name}")(*map(_ptr, tensors), *ints, stream)
    if err:
        msg = lib.qt_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} ({msg})")
    LAUNCHES[count or name] += 1


def build_dir() -> Path:
    """Where the kernels are built: ``$QINCO_TORCH_BUILD_DIR`` or
    ``build/qinco_torch_kernels`` beside the package."""
    env = os.environ.get("QINCO_TORCH_BUILD_DIR")
    return Path(env) if env else _CSRC.parent.parent / "build" / "qinco_torch_kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile each kernel of ``names`` (default: every kernel) that has no
    up-to-date library yet, one ``nvcc`` per source, all started together.
    Returns each kernel's
    ``ptxas`` report (registers, spills, shared memory); empty for a
    library that was already built.  Ranks of a process group that build
    at once each compile into a name of their own (the pid) and rename it
    over the library, an atomic replace by the same bytes, as
    ``search.index.build_native`` does (two ranks building that one at once
    are checked in ``tests/test_torch_parallel.py``)."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in _KERNELS if names is None else names:
        src = _KERNELS[name][0]
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed for {_KERNELS[name][0]}:\n{log}")
            continue
        tmp.rename(lib)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


_LIBS: dict[str, ctypes.CDLL] = {}


def _lib(name: str, device: torch.device) -> ctypes.CDLL:
    """The kernel's library, built (with the others of its group) and
    loaded at first use; raises unless ``device`` is a Hopper card (sm_90)."""
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; {device} is sm_{major}{minor}")
    if name in _LIBS:
        return _LIBS[name]
    build(next(group for group in _BUILD_GROUPS if name in group))
    lib = ctypes.CDLL(str(_lib_path(name)))
    _, n_ptr, n_int = _KERNELS[name]
    fn = getattr(lib, f"qt_{name}")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.qt_error_string.argtypes = [ctypes.c_int]
    lib.qt_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib
