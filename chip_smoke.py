"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n 8192]

1. Prints the card's name and power limit, turns TF32 off.
2. Builds the kernels from ``qinco_torch/csrc`` and, beside them, the
   native IVF library from ``native/``, and prints the seconds.
3. Kernel phase: each kernel against its plain PyTorch version on the
   card at the main paths' shapes (qinco2-S at N=1024 vectors: a normal
   step and the IVF first step), at the qinco2-M widths (in/out
   projections, L=4) and at qinco2-L (L=16, de=dh=384, the deep route of
   the JAX kernels; ``DEEP_REPS`` timed calls), with the tolerances of
   ``tests/test_torch_cuda.py``;
   one JSON line per kernel and shape with the median ms of one call
   from CUDA events (``ms``) and of back-to-back calls (``ms_batch``,
   where the wrapper's host work overlaps the previous call's kernel),
   the plain version's ms, the bound, the achieved TFLOP/s and the
   kernel's design (tensor cores or CUDA cores):
   - selected scores with the in-kernel top-A (parity profile) and with
     external vals (the f32 folded table of ``pallas=true``, the bf16
     lean table of ``fused_topa=false``); select-rebuild;
   - fused-substep scores (speed profile; also its f32 route);
   - candidate scores at K=1024 (unpacked; also at the qinco2-M widths) and
     at K=256 with a low-rank concat factor (packed), and select-rebuild
     with that factor;
   - the f32 routes, whose ``design`` names the register-tiled f32 stage:
     fused-substep scores in each table layout (fold_up, ``fold_up=false``,
     the low-rank factor) at qinco2-S, at its IVF first step and at the
     qinco2-M widths; select-rebuild at the qinco2-S and -M widths; selected
     scores (external vals at the qinco2-S and -M widths, the in-kernel
     top-A at qinco2-S with select-rebuild on its output) and candidate
     scores (K=1024 at the qinco2-S and -M widths, the low-rank factor at
     qinco2-S with select-rebuild on its output);
   - at qinco2-L: selected scores with the in-kernel top-A (and
     select-rebuild on its output) and fused-substep scores, each at bf16
     and f32; selected scores with external vals (``pallas=true``);
     candidate scores at K=1024, bf16 and f32;
   - at qinco2-L and D = ``WIDE_D`` (768, Contriever's width), where B2's
     and B3's plans take D in column passes (checked): selected scores
     with the in-kernel top-A (and select-rebuild on its output) and with
     external vals (``fused_topa=false``), each at a normal step and the
     IVF first step;
   - the IVF step 0's kernel (``chunked_argmin``, csrc/nearest.cu) at the
     encode's chunk of 1024 rows on a 2^20-row book, D = 128 and
     ``WIDE_D``, against the plain loop it replaces (the cuBLAS product
     and row min), its launches (the kernel and the merge), the memory a
     call allocates (no distance tile), its ms beside the plain loop's
     (``ivf_kernel_checks``; one ``{"ivf_step": ...}`` line).
   Between the qinco2-S checks and the qinco2-L ones, the breakdown phase
   (``breakdown_phase``): the phase-breakdown kernels of
   ``qinco_torch.ops.breakdown`` (B2's seven kernels at N=1024: its nine
   modes, ``deferred`` and ``catfetch`` being ``full``'s kernel; at
   N=4096 B4's cuts ``sel``, ``sel+fetch`` (also ``fetchb``), ``dsub``,
   ``mlponly`` and ``fullopt``, ``selcat``, the streaming probes ``noop``
   and ``bw`` (f32 and bf16), and production B4 on the script's operands,
   which ``perbin`` and ``sgfetch`` launch; on the inputs of the two
   breakdown scripts), each against its plain version (``nodist`` and
   ``mlponly`` against sums exact to float64, with planted faults that
   the bound must reject); then the two entry scripts' ``run``
   (``scripts/torch_ktopa_breakdown.py``; every ``--variants`` name of
   ``scripts/torch_kernel_variants.py``) with the launch counts at 0,
   every breakdown kernel launched, and one ``{"breakdown": ...}`` line:
   each variant's device ms a launch and bound, B2's phase split and B4's
   (selection, fetch, bin minimum, the MLP chain alone, the streaming
   floors).
4. Path phase at qinco2-S, random weights and data from ``--seed`` (the
   data: decodes of random codes plus noise of std ``NOISE``, or
   ``SPEED_NOISE`` for the speed profile), through ``encode_chunked``
   (batch 1024) over ``--n`` vectors, then ``decode``: the parity and the
   speed profile without and with the IVF step 0 (ivf_K = 2^20), the speed
   profile at f32, ``pallas=true`` (f32) at K=256 and at K=1024, and the
   parity profile at K=1024; then at qinco2-L the parity profile without
   and with the IVF step 0 (codes agreeing with exact on >=
   ``DEEP_MIN_AGREE``), the speed profile (its MSE against exact printed,
   not bounded: ``deep_paths``), and the parity selection at f32
   (``pallas=true fast_encode=true``, >= 0.99); then at qinco2-L and
   D = ``WIDE_D`` the parity profile without and with the IVF step 0
   (``wide_paths``, as the deep paths).  Each checks
   the kernels' launch counts exactly (one launch of its scoring kernel
   and, with packed ids, of select-rebuild per MLP step and chunk, none of
   the others), encode xhat against decode(codes), and its MSE and codes
   against ``encode_profile=exact`` on the first chunk (1024 vectors; at
   qinco2-L the exact encode runs the f32 MLP on the A=16 pre-selected
   candidates of each beam, about 0.036 TFLOP a vector).  Prints
   encode vectors per second (one ``encode_chunked`` over all vectors),
   decode vectors per second (the median of ``DECODE_WINDOWS`` windows of
   ``DECODE_REPS`` decodes of all of them), and the device time by kernel
   of one encode chunk and of one decode (torch.profiler); on the f32
   paths the scoring kernel's f32 route must lead that profile, with
   select-rebuild's among its top kernels.
5. Train phase at qinco2-S (parity profile): ``python -m qinco_torch``'s
   ``main`` trains on ``TRAIN_ROWS`` + ``TRAIN_VAL`` rows of the smoke's
   data (noise ``NOISE``) written to an .npy: the RQ bootstrap on the card,
   then 2 epochs of ``TRAIN_LOOP`` rows at batch 1024 (32 optimizer steps,
   each encoding through the kernels), the validation MSE per epoch, the
   checkpoint; then ``task=eval`` of the checkpoint on the held-out rows.
   Its log goes to stderr.  Checks the launch counts (7 selected-scores and
   7 select-rebuild launches per step and per validation batch), that the
   validation MSE fell, every logged loss is finite and the eval gives the
   checkpoint's validation MSE (rtol 1e-4); then, from the
   checkpoint's weights on one batch, the ms of a step (and, in turns, of
   the same step with plain autograd gathers, whose backward adds by
   atomics), one step's device time by kind (torch.profiler), and one step
   under the parity profile against one under ``exact`` (loss ratio <=
   1.01, codes agree >= 0.9).
   Then two short runs of ``task=train`` from one seed (the RQ bootstrap's
   k-means, 4 steps, their validation passes) must end at the same
   parameters, log the same losses and launch the same kernels, bit for
   bit.  Then qinco2-L: ``task=train model_args=qinco2-L`` on
   ``DEEP_TRAIN_ROWS`` + ``DEEP_TRAIN_VAL`` rows of its own random model's
   data (the RQ bootstrap, then 16 steps at batch 1024), with the same
   checks of launches, losses and the falling validation MSE, and
   ``task=eval`` of its checkpoint; the checkpoint's ``DEEP_TRAIN_VAL``
   held-out rows as two paths of item 4, parity (MSE <= 1.01x exact,
   codes agreeing >= 0.9) and speed (<= 1.05x); the ms of a parity step
   from the checkpoint's weights and its device time by kind.  One
   ``{"train_qinco2_L": ...}`` line.
6. Search phase at qinco2-S width (parity), through the search tasks of
   ``python -m qinco_torch``: first one assignment-and-accumulate pass of
   the k-means at ivf_K = 2^20 over 2^18 random rows, timed, with its f32
   TFLOP/s and what it projects for the reference's 50M rows x 100
   iterations; then ``task=ivf_centroids`` (ivf_K = 2^16, 10 iterations)
   on 2^19 decodes of a random IVF model; a random qinco2-S model on those
   centroids, written as a checkpoint, and its data (decodes of random
   codes plus noise ``NOISE``): 2^19 training rows (plus 10,000 validation
   rows) and a DB of 2^20 rows, 10,000 queries = DB rows plus noise
   ``QUERY_NOISE``, their ground truth by brute force on the card;
   ``task=encode`` of the training set and of the DB (vec/s from data load
   to part file; launch counts exact: selected scores and select-rebuild
   once per MLP step and chunk; the part file's first chunk equal to
   ``encode_chunked``'s), ``task=build_index`` (ntotal = 2^20, the AQ MSE
   finite), ``task=train_pairwise_decoder`` and ``task=search`` over
   nprobe in {16, 64} x nmid_short in {0, 4} at nshort = 100, each point's
   recall and ms per query by stage; R@100 >= 0.95 at nprobe = 64.  The
   device time by kernel of one pair fit of the pairwise decoder and of
   one search task at one point (torch.profiler) close the phase.
7. Legacy phase, through the QINCo1-era tasks of ``python -m qinco_torch``
   (parity profile where a QINCo2 model encodes):
   - ``task=convert`` of the train phase's checkpoint written out as a
     reference ``.pt`` state dict: the converted parameters (and EMA
     buffers) equal the original's bit for bit, and ``task=encode_codec``
     of the 8,192 held-out rows gives the same codes with either
     checkpoint; a QINCo1-era ``.pt`` at bigann widths (random weights,
     the v1 module layout) converted with ``db=bigann1B`` takes the
     asset's norms;
   - ``encode_codec`` of ``CODEC_ROWS`` rows to ``.npy`` codes and to a
     packed file (8 bytes a vector), ``decode_codec`` of both: equal, and
     equal to ``decode_raw`` of the codes; vec/s of each task from data
     load to written file, and the exact B2 and B3 launch counts;
   - ``task=search_2stage``: the AQ fit on ``TWO_STAGE_TRAIN`` rows, a
     2^20-row DB, 10,000 queries (DB rows plus noise ``QUERY_NOISE``)
     with brute-force ground truth, at each of ``TWO_STAGE_NSHORT``:
     R@1/10/100 and ms per query of the shortlist and the rerank;
     R@100 >= 0.95; the device time by kernel of one 256-query shortlist
     and of one rerank decode batch (torch.profiler);
   - ``task=train_pq`` with OPQ (``PQ_ARGS``) on ``PQ_TRAIN`` +
     ``PQ_VAL`` rows of D = 256 synthetic data (``epochs=1``,
     ``scheduler.stop_patience=0``), then ``task=eval_pq`` on a
     ``PQ_DB``-row DB with ``PQ_QUERIES`` queries: the seconds of OPQ,
     of each part and of the eval, the validation and DB MSE, R@1/10/100,
     encode vec/s, the peak device memory of ``train_pq`` (its closing
     report encodes 10,000 rows in one call), no kernel launched (the
     exact profile); the ``.pqnpz``'s encode on the card against the
     CPU's, and the device time by kernel of one 1024-row encode.
   One ``{"legacy": ...}`` line, with a ``reduced`` list of each cut.
8. Distributed phase, after the train phase, on its data, each group a
   one-rank NCCL group over loopback; the CLI runs start it the way users
   do: ``python -m torch.distributed.run --standalone --nproc_per_node=1``.
   - ``-m qinco_torch task=train`` with the arguments of the first
     repeated run: the same parameters, model state, logged losses and
     validation MSEs, bit for bit, and the same kernel launches (the
     ``Kernel launches`` line of the task's log);
   - ``task=encode`` of ``DIST_ENCODE_ROWS`` training rows with that
     checkpoint, under the group and (``python -m qinco_torch``) without:
     ``n_parts == 1``, the two part files equal, the exact B2 and B3
     launch counts, each run's encode vec/s;
   - a worker (this script with ``--dist-worker``, rank 0 of a world of
     one through torchrun's variables): ``sharded_coarse_topk`` over a
     ``TOPK_BOOK`` x 128 book for ``TOPK_QUERIES`` queries at k =
     ``TOPK_K`` gives ``sqdist_topk``'s ids, and the ms of each; from the
     train phase's checkpoint, on one batch, a parity train step with the
     mesh equals one without it bit for bit and makes ``2·Ms + 4``
     collectives (their bytes recorded); the ms of a step without the mesh
     and with it (CUDA events; 12 turns of 10 steps in the order plain,
     group, group, plain; the median turn of each, and the median
     group-minus-plain of the 6 side-by-side pairs), the 10 host operations with the most
     self CPU time in one plain and one group step (torch.profiler), and
     the host and device ms of one all-reduce of a statistics-sized and of
     a step-sized buffer.
   One ``{"dist": ...}`` line; the group runs' launches join the kernel
   summary's counts.
9. Scale phase: ``scripts/torch_scale_regression.py`` in this process
   (qinco2-S, parity) at ``SCALE_ARGS``, the reference's 10M-row, IVF 2^16
   pipeline cut to a 2^18-row DB, 2^17 training rows, 1024 queries,
   ivf_K = 4096, 10 k-means iterations and one epoch: its data, the exact
   ground truth, ``ivf_centroids``, ``train``, the encodes of the training
   set and the DB, ``build_index``, the validations, the pairwise decoder,
   the search sweep and the Pareto check.  Every phase of the JAX
   package's record (``SCALE_RECORD``) ran and the report has every key of
   it; B2 and B3 launched exactly the counts the script expects in
   training and in each encode, and no kernel outside a phase; R@1 at
   nprobe 64, nshort 100 is at least ``SCALE_MIN_R1``.  One ``{"scale":
   ...}`` line: the phases' seconds, the operating points, the launches
   and peak device memory of each phase.
10. The smoke's total seconds (``smoke_s``), the kernel summary line (each
   kernel's numbers at its qinco2-S main shape, its launches over every
   phase; the breakdown kernels' at the breakdown phase's shapes, ``ms``
   their device ms a launch, their launches on the entry scripts' run,
   ``body`` the TPU kernel's body; ``perbin`` and ``sgfetch`` as aliases
   of production B4 with its numbers at the script's shapes), so that
   every ``pl.pallas_call`` of the repo has an entry,
   then ``{"ok": true, "device": ...}`` last.

Any failed check raises and the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from qinco_torch.__main__ import main as qinco_main
from qinco_torch.checkpoint import SAVED_PARAMETERS, load_checkpoint, save_checkpoint
from qinco_torch.config import load_config
from qinco_torch.models.params import (
    QincoParams,
    StepParams,
    init_model_state,
    init_params,
    param_leaves,
)
from qinco_torch.models import qinco as qinco_model
from qinco_torch.models.qinco import decode, decode_raw, encode, encode_chunked
from qinco_torch.models.spec import spec_from_cfg
from qinco_torch.ops import breakdown, kernels
from qinco_torch.ops.distances import chunked_argmin, chunked_argmin_plain, sqdist_topk
from qinco_torch.ops.kmeans import DIST_BUDGET_ELEMS, accumulate_pass
from qinco_torch.parallel import distributed as pdist
from qinco_torch.parallel import mesh as pmesh
from qinco_torch.parallel.sharded_ops import shard_codebook, sharded_coarse_topk
from qinco_torch.search.index import build_native
from qinco_torch.search.pairwise_decoder import EVAL_ROWS
from qinco_torch.search.pairwise_decoder import _pair_error as pair_error
from qinco_torch.train import train_step as tts

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# Decode timing: DECODE_WINDOWS windows of DECODE_REPS decodes of all the
# vectors each.  One decode takes milliseconds and is launched op by op
# from the host, so one window's rate follows the host's load; the metric
# is the median window.
DECODE_WINDOWS, DECODE_REPS = 9, 10
# Rank of the low-rank concat factor in the candidate-route checks.
CONCAT_RANK = 64
# Std of the noise added to the data's exact decodes (synthetic_data):
# NOISE for the paths with an exact per-step selection, SPEED_NOISE for the
# speed profile's binned selection, whose loss at NOISE, where each vector
# sits at its exact code's noise floor, exceeds the 1.05x bound in the JAX
# package as in the port (PERF.md, section 6).
NOISE, SPEED_NOISE = 0.05, 0.5
# Train phase: training and validation rows, rows an epoch (ds.loop) and batch.
TRAIN_ROWS, TRAIN_VAL, TRAIN_LOOP, TRAIN_BATCH = 65536, 8192, 16384, 1024
# The repeated short run: rows an epoch, 2 epochs = 4 steps.
REPEAT_LOOP = 2048
# qinco2-L (L=16, de=dh=384): calls timed per kernel check.
DEEP_REPS = 6
# The least code agreement with the exact profile of the qinco2-L bf16
# parity paths: bf16 rounding through 16 blocks flips near-equal
# candidates in the late steps, whose codebooks are small beside the
# rounding of the residual (NVIDIA H100 80GB HBM3, 700 W: 0.887-0.920
# over 1024 vectors, per step 1.0 at the first four falling to 0.66-0.72
# at the last, at 1.000x the exact MSE); the same selection at f32 (the
# ``pallas=true fast_encode=true`` path) agrees on >= 0.99.
DEEP_MIN_AGREE = 0.85
# The width of the wide checks and paths (Contriever's), where B2 and B3 at
# the qinco2-L widths take D in column passes.
WIDE_D = 768
# The wide paths' MSE bound against the exact profile: the parity decode's
# own rounding at D = 768 (``wide_paths``), as tests/test_torch_encode_wide.py
# bounds the parity profile there.
WIDE_MSE_BOUND = 1.05
# The qinco2-L train run's rows, held-out rows and rows an epoch (2 epochs
# at batch TRAIN_BATCH: 16 optimizer steps).
DEEP_TRAIN_ROWS, DEEP_TRAIN_VAL, DEEP_TRAIN_LOOP = 32768, 8192, 8192
# Distributed phase: DB rows of its encode runs; the sharded top-k's book
# rows (the production IVF book), queries and k.
DIST_ENCODE_ROWS = 16384
TOPK_BOOK, TOPK_QUERIES, TOPK_K = 1 << 20, 1024, 64
ROOT = Path(__file__).resolve().parent
# Search phase (scripts/scale_regression.py's anchor, D=128, ivf_K = 2^16,
# its 10M-row DB cut to fit the smoke): training rows (plus the config's
# validation rows), DB rows, queries, k-means iterations.
SEARCH_IVF_K, SEARCH_TRAIN, SEARCH_VAL = 1 << 16, 1 << 19, 10_000
SEARCH_DB, SEARCH_QUERIES, SEARCH_KMEANS_ITERS = 1 << 20, 10_000, 10
QUERY_NOISE = 0.01
# One assignment-and-accumulate pass of the production IVF k-means
# (ivf_K = 2^20) over KMEANS_PASS_ROWS rows, projected to the reference's
# KMEANS_REF_ROWS training rows and KMEANS_REF_ITERS iterations.
KMEANS_PASS_K, KMEANS_PASS_ROWS = 1 << 20, 1 << 18
KMEANS_REF_ROWS, KMEANS_REF_ITERS = 50_000_000, 100
# Legacy phase: rows of the encode_codec / decode_codec runs; the flat
# two-stage search (the reference's qinco_v1/search_2stage.py over a 1M
# DB): AQ training rows (plus the config's validation rows), DB rows,
# queries and shortlist sizes; PQ-QINCo at the documented 2x16x8 with OPQ
# (docs/pq_qinco.md) on D = 256 synthetic data, the width of FB-ssnpp:
# training and validation rows, DB rows and queries.
CODEC_ROWS = 1 << 18
TWO_STAGE_TRAIN, TWO_STAGE_VAL, TWO_STAGE_DB, TWO_STAGE_QUERIES = 1 << 18, 10_000, 1 << 20, 10_000
TWO_STAGE_NSHORT = (100, 1000)
PQ_D, PQ_TRAIN, PQ_VAL, PQ_DB, PQ_QUERIES = 256, 1 << 17, 10_000, 1 << 18, 1000
PQ_ARGS = ["pq_parts=2", "opq=true", "M=16", "K=256", "L=2", "de=128", "dh=256", "A=0", "B=1"]

# Scale phase: scripts/torch_scale_regression.py (qinco2-S, parity) with the
# reference's 10M-row pipeline cut to these sizes; the least R@1 at nprobe
# 64, nshort 100; the JAX package's record of the full run, whose report
# keys and phases the port's report must have.
SCALE_ARGS = ["--db-size", "262144", "--train-size", "131072", "--nq", "1024",
              "--ivf-k", "4096", "--kmeans-iters", "10", "--epochs", "1"]
SCALE_MIN_R1 = 0.95
SCALE_RECORD = ROOT / "bench_artifacts" / "scale_report_v4_2026-08-20.json"

# kernel -> (source, the TPU kernel it replaces)
SOURCES = {
    "selected_scores": ("qinco_torch/csrc/selected_scores.cu",
                        "qinco_tpu/ops/pallas_kernels.py:880"),
    "select_rebuild": ("qinco_torch/csrc/select_rebuild.cu",
                       "qinco_tpu/ops/pallas_kernels.py:1211"),
    "fused_substep_scores": ("qinco_torch/csrc/fused_substep_scores.cu",
                             "qinco_tpu/ops/pallas_kernels.py:483"),
    "candidate_scores": ("qinco_torch/csrc/candidate_scores.cu",
                         "qinco_tpu/ops/pallas_kernels.py:1019"),
}
# the line of each production kernel's pl.pallas_call
PALLAS_CALLS = {"selected_scores": 1003, "select_rebuild": 1320, "fused_substep_scores": 612,
                "candidate_scores": 1103}
# the phase-breakdown kernels (launch-count name -> source, the TPU kernel's
# pallas_call, its body)
_KV = "scripts/kernel_variants.py"
BREAKDOWN_SOURCES = {
    **{f"ktopa_variant:{m}": ("qinco_torch/csrc/ktopa_variants.cu",
                              "scripts/ktopa_breakdown.py:335", "scripts/ktopa_breakdown.py:104")
       for m in kernels.KTOPA_KERNELS},
    **{f"fused_cut:{c}": ("qinco_torch/csrc/fused_cuts.cu", f"{_KV}:182", f"{_KV}:{line}")
       for c, line in (("sel", 118), ("sel+fetch", 123), ("dsub", 756), ("mlponly", 886),
                       ("fullopt", 198))},
    "selcat": ("qinco_torch/csrc/ktopa_variants.cu", f"{_KV}:727", f"{_KV}:638"),
    "stream_probe:noop": ("qinco_torch/csrc/stream_probes.cu", f"{_KV}:182", f"{_KV}:782"),
    "stream_probe:bw_f32": ("qinco_torch/csrc/stream_probes.cu", f"{_KV}:810", f"{_KV}:804"),
    "stream_probe:bw_bf16": ("qinco_torch/csrc/stream_probes.cu", f"{_KV}:810", f"{_KV}:804"),
}
# The TPU kernels of kernel_variants.py whose function is production B4's
# (their pallas_call, body): on the card they launch B4's kernel, which
# gathers by id where they fetch through TPU layouts (per-bin one-hot
# products; a block-diagonal table); they have no counter or timing of
# their own.
B4_ALIASES = {"perbin": (f"{_KV}:371", f"{_KV}:275"), "sgfetch": (f"{_KV}:500", f"{_KV}:388")}
# Breakdown phase: calls timed back to back per variant in the entry scripts.
BREAKDOWN_ITERS = 20
# The IVF step's kernel: its tolerance against the plain loop (of the size
# of a distance's terms, tests/test_torch_nearest.py) and its design.
IVF_RTOL = 1e-5
IVF_DESIGN = ("cuda cores f32 (x block resident or streamed, book slices through shared memory, "
              "8 x 8 register tiles, running first minimum, splits merged in order)")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok, what: str) -> None:
    """A smoke check: raises (and so fails the run) when ``ok`` is false."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, from CUDA events around
    each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def batch_ms(fn, calls: int = 10, windows: int = 5) -> float:
    """Median over ``windows`` of the ms per call of ``calls`` back-to-back
    calls of ``fn()`` between two CUDA events."""
    fn()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# kernel -> the name of its f32 route, the register-tiled stage of
# csrc/f32_tile.cuh (what the profiles of the f32 paths show).
F32_TILED = {
    "selected_scores": "selected_scores_f32_kernel",
    "select_rebuild": "select_rebuild_f32_kernel",
    "fused_substep_scores": "fused_substep_f32_kernel",
    "candidate_scores": "candidate_scores_f32_kernel",
}


def design(name: str, dtype: str) -> str:
    """How a kernel computes its MLP products: on the tensor cores under
    bf16 (B2 on wgmma, the others on mma.sync), in f32 on the CUDA cores
    under f32, through the shared-memory weight ring and register tiles."""
    if dtype == "bfloat16":
        if name == "selected_scores":
            return "tensor cores (wgmma, bulk-copy weight ring, clusters)"
        return "tensor cores (mma.sync)"
    return f"cuda cores f32 (bulk-copy weight ring, register-tiled FFMA: {F32_TILED[name]})"


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _dims(spec):
    return spec.D, spec.K, spec.De, spec.dh, spec.L


def _ffn_flops(spec, blocks):
    return blocks * 2 * (2 * spec.De * spec.dh)


def _ffn_bytes(spec, esize):
    D, K, De, Dh, L = _dims(spec)
    return 2 * L * De * Dh * esize + (De * D * esize if De != D else 0)


def selected_work(spec, N, F_in, A, esize, external=False):
    """FLOPs and bytes of the selected-scores function at these shapes:
    the substep distances over K (in-kernel top-A only), the condition
    product, and per slot the lean fetch times wfold (``spec.fast``; the
    folded table fetches that column), the FFN blocks, out_proj and the
    distance.  Bytes: x, xh, the packed external vals and the packed output
    once, the step's weights (and the table) once."""
    D, K, De, Dh, L = _dims(spec)
    NF = N * F_in
    per_slot = (2 * D * De if spec.fast else 0) + _ffn_flops(spec, L) + (
        2 * De * D if De != D else 0) + 3 * D
    flops = NF * ((0 if external else 2 * K * D) + 2 * D * De + A * per_slot)
    table = K * (D if spec.fast else D + De) * esize
    weights = (0 if external else K * D * 4) + table + D * De * esize * (2 if spec.fast else 1)
    nbytes = 4 * (N * D + NF * D + NF * A * (2 if external else 1)) + weights + _ffn_bytes(
        spec, esize)
    return flops, nbytes


def fused_work(spec, N, F_in, A, esize, out_proj=None):
    """FLOPs and bytes of the fused-substep function (fold_up table):
    substep distances over K, per row the condition product and its
    product with the first up-projection, per slot the rest of FFN block 0,
    blocks 1..L-1, out_proj and the distance.  Bytes: x, xh and the packed
    output once; the substep codebook, the (K, D + De + Dh) table and the
    weights once.  ``out_proj``: whether there is one (default: De != D)."""
    D, K, De, Dh, L = _dims(spec)
    NF = N * F_in
    proj = De != D if out_proj is None else out_proj
    per_slot = 2 * Dh * De + _ffn_flops(spec, L - 1) + (2 * De * D if proj else 0) + 3 * D
    flops = NF * (2 * K * D + 2 * D * De + 2 * De * Dh + A * per_slot)
    weights = (K * D * 4 + K * (D + De + Dh) * esize + D * De * esize
               + 2 * L * De * Dh * esize + (De * D * esize if proj else 0))
    nbytes = 4 * (N * D + NF * D + NF * A) + weights
    return flops, nbytes


def _chain_flops(spec, rank):
    """FLOPs of the unfolded step MLP for one pair (_mlp_chain)."""
    D, K, De, Dh, L = _dims(spec)
    concat = 2 * (De + D) * (rank or De) + (2 * rank * De if rank else 0)
    return (2 * D * De if De != D else 0) * 2 + concat + _ffn_flops(spec, L)


def _chain_bytes(spec, rank, esize):
    D, K, De, Dh, L = _dims(spec)
    concat = (De + D) * (rank or De) * esize + (rank * De * esize if rank else 0)
    return concat + _ffn_bytes(spec, esize) + (D * De * esize if De != D else 0)


def candidate_work(spec, NF, A, esize, rank):
    """FLOPs and bytes of candidate scores for NF rows of A ids: the
    condition half of the concat product, rnd(xh)·W2, once per row (it is
    the same for a row's A ids), the rest of the unfolded MLP and the
    distance per pair.  Bytes: x, xh, the ids and the output once, the dt
    codebook and the weights once."""
    D, K = spec.D, spec.K
    cond = 2 * D * (rank or spec.De)
    flops = NF * (cond + A * (_chain_flops(spec, rank) - cond + 3 * D))
    nbytes = 4 * (2 * NF * D + 2 * NF * A) + K * D * esize + _chain_bytes(spec, rank, esize)
    return flops, nbytes


def rebuild_work(spec, N, F_in, A, F_out, esize, rank=None):
    """FLOPs and bytes of select-rebuild: the MLP for N·F_out pairs (the
    selection's compares are not counted).  Bytes: dists, xh, the f32
    codebook and weights read once, xhat, codes and parents written once."""
    D, K = spec.D, spec.K
    flops = N * F_out * _chain_flops(spec, rank)
    nbytes = 4 * (N * F_in * A + N * F_in * D + K * D) + _chain_bytes(spec, rank, esize) + (
        4 * N * F_out * (D + 2))
    return flops, nbytes


def ktopa_work(spec, N, F_in, A, mode):
    """FLOPs and bytes of a ``ktopa_variant`` kernel's function: B2's
    (``selected_work``) for ``full``, ``perslot`` and ``tournament``.  The
    cuts fix their ids (slot a: codeword a), so their output needs no
    substep products and no substep codebook: ``noextract`` the condition
    product, then per slot the MLP and the distance on codeword a, and A
    rows of the table; ``mlponly``, ``nodist`` and ``shell`` give all A
    slots of a row one candidate, codeword 0, so they need one slot's work
    a row and one row of the table: ``mlponly`` the condition product, the
    MLP and the distance (3·D), ``nodist`` the same with the sum of
    out + cand (D), ``shell`` ||r - cand||^2 alone (3·D, no weights).
    Bytes: x, xh and the (NF, A) output once, and what each reads of the
    table and the weights."""
    if mode in ("full", "perslot", "tournament"):
        return selected_work(spec, N, F_in, A, 2)
    D, K, De, Dh, L = _dims(spec)
    NF, esize = N * F_in, 2
    slots = A if mode == "noextract" else 1
    rows = slots * (D if spec.fast else D + De) * esize
    io = 4 * (N * D + NF * D + NF * A)
    if mode == "shell":
        return NF * 3 * D, io + rows
    mlp = (2 * D * De if spec.fast else 0) + _ffn_flops(spec, L) + (2 * De * D if De != D else 0)
    flops = NF * (2 * D * De + slots * (mlp + (D if mode == "nodist" else 3 * D)))
    weights = D * De * esize * (2 if spec.fast else 1) + _ffn_bytes(spec, esize)
    return flops, io + rows + weights


def fused_cut_work(spec, N, F_in, A, cut, Wt):
    """FLOPs and bytes of a ``fused_cut``: the substep products (the bin
    minima's compares not counted), for ``sel+fetch`` the squares of the
    winners' Wt-wide rows; x, xh, the substep codebook, the (K, Wt) bf16
    table (``sel+fetch``) and the (NF, A) output once."""
    D, K = spec.D, spec.K
    NF = N * F_in
    fetch = cut == "sel+fetch"
    flops = NF * 2 * K * D + (NF * A * 2 * Wt if fetch else 0)
    nbytes = 4 * (N * D + NF * D + NF * A) + K * D * 4 + (K * Wt * 2 if fetch else 0)
    return flops, nbytes


def variant_work(spec, N, F_in, A, name, Wt):
    """FLOPs and bytes of the V4-V8 kernels of ``kernel_variants.py`` at
    the script's operands (in and out projections, bf16), for what each
    function needs:
    - ``dsub``: the substep products and the bins' sums; x, xh, the substep
      codebook and the (NF, A) output once;
    - ``mlponly``: one slot a row (every slot of a row takes T's row 0, so
      all A are equal): the condition product, the L stand-in blocks,
      W_out and the distance; x, xh, the output, T's row 0 (f32) and the
      four stand-in weights (the blocks share theirs) once;
    - ``fullopt``: the substep products, the condition product a row, and a
      slot a bin: the L blocks, W_out and the distance; x, xh, the output,
      the substep codebook, T (bf16) and the stand-in weights once;
    - ``selcat``: per row the condition product, per slot the L blocks,
      out_proj and the distance; x, xh, the packed vals and output, the
      folded (K, D + de) table and the step's weights once."""
    D, K, De, Dh, L = _dims(spec)
    NF, esize = N * F_in, 2
    io = 4 * (N * D + NF * D + NF * A)
    chain = _ffn_flops(spec, L) + 2 * De * D + 3 * D  # a slot's blocks, W_out, distance
    stand_in = (2 * D * De + 2 * De * Dh + De * D) * esize  # W2, up, down, W_out
    if name == "dsub":
        return NF * (2 * K * D + K), io + K * D * 4
    if name == "mlponly":
        return NF * (2 * D * De + chain), io + Wt * 4 + stand_in
    if name == "fullopt":
        return (NF * (2 * K * D + 2 * D * De + A * chain),
                io + K * D * 4 + K * Wt * esize + stand_in)
    if name == "selcat":
        weights = (K * (D + De) + D * De + 2 * L * De * Dh + De * D) * esize
        return NF * (2 * D * De + A * chain), io + 4 * NF * A + weights
    raise ValueError(name)


def probe_work(xh, kind, rows, A):
    """FLOPs and bytes of a streaming probe: ``noop`` reads and writes
    NF·A f32 values (one product each); ``bw`` reads xh once (an add a
    value) and writes 8 rows of D f32 sums a tile."""
    NF, D = xh.shape
    if kind == "noop":
        return NF * A, 8 * NF * A
    return NF * D, NF * D * xh.element_size() + -(-NF // rows) * 8 * D * 4


def spec_of(preset, *extra, profile="parity", D=128):
    """The spec of a preset at width D, with extra overrides and an encode
    profile (none for profile=None)."""
    overrides = [f"model_args={preset}", *extra]
    if profile:
        overrides.append(f"encode_profile={profile}")
    return spec_from_cfg(load_config(overrides), D=D)


def random_model(spec, seed: int, device):
    """Parameters from ``seed``: the zero-initialized concat and FFN-down
    weights randomized (else the MLP is a no-op), step codebooks scaled
    down per step as residual codebooks are, a random IVF book."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = init_params(spec, g, device=device)

    def fill(a):  # a small random refinement: 0.1 / sqrt(fan_in) per weight
        if a is None or a.any():
            return a
        fan_in = a.shape[-2] if a.dim() > 2 else a.shape[-1]
        return (0.1 / fan_in ** 0.5) * torch.randn(a.shape, generator=g, device=device)

    steps = StepParams(*(fill(a) for a in p.steps))
    scale = 0.5 ** torch.arange(1, spec.n_mlp_steps + 1, device=device, dtype=torch.float32)
    steps = steps._replace(codebook=steps.codebook * scale[:, None, None])
    if steps.sub_codebook is not None:
        steps = steps._replace(sub_codebook=steps.codebook.clone())
    codebook0 = p.codebook0
    if spec.ivf_in_use:
        codebook0 = torch.randn((spec.ivf_K, spec.D), generator=g, device=device)
    return QincoParams(codebook0, steps, p.data_mean, p.data_std)


def synthetic_data(spec, params, n: int, seed: int, noise: float) -> np.ndarray:
    """``n`` raw-space vectors on the host: the exact decode of random codes
    plus Gaussian noise of std ``noise`` per dimension (the decodes spread
    by about 1.15 per dimension).  At 0.05 (``NOISE``) each vector lies at
    the noise floor of its exact code, where any pre-selection's loss shows
    at full weight; at 0.5 (``SPEED_NOISE``) the exact encode's relative
    error is 6-8% at D=32 and 64."""
    device = params.codebook0.device
    g = torch.Generator(device=device).manual_seed(seed + 2)
    codes = torch.stack([torch.randint(0, k, (n,), generator=g, device=device)
                         for k in spec.K_vals])
    x = decode_raw(params, spec.with_(compute_dtype="float32"), codes)
    x = x + noise * torch.randn(x.shape, generator=g, device=device)
    return x.cpu().numpy()


def _unpacked(v):
    return (v.view(torch.int32) & ~0xFF).view(torch.float32)


def compare_scores(label, got, want, dtype) -> float:
    """Packed scores: ids agree on >= 99.5% (f32) / 98% (bf16) of slots,
    and where they agree the distances within rtol 1e-4 / 1e-2."""
    same = kernels.unpack_ids(got) == kernels.unpack_ids(want)
    agree = same.float().mean().item()
    need = 0.995 if dtype == "float32" else 0.98
    check(agree >= need, f"{label}: ids agree on {agree:.4f} < {need}")
    dg, dw = _unpacked(got)[same], _unpacked(want)[same]
    torch.testing.assert_close(dg, dw, rtol=1e-4 if dtype == "float32" else 1e-2, atol=1e-4)
    return (dg - dw).abs().max().item()


def kernel_check(name, label, spec, run, plain, compare, work, reps=20, **info) -> dict:
    """One kernel against its plain version at one shape: the comparison,
    the kernel's median ms over ``reps`` calls (and of back-to-back calls),
    the plain version's, the bound, the achieved TFLOP/s; one JSON line."""
    got, want = run(), plain()
    err = compare(got, want)
    flops, nbytes = work
    b_ms, b_by = bound_ms(flops, nbytes, spec.compute_dtype)
    ms = time_ms(run, reps=reps)
    ms_batch = batch_ms(run, calls=max(reps // 2, 2), windows=5 if reps >= 20 else 3)
    res = dict(name=name, shape=label, **info, design=design(name, spec.compute_dtype),
               max_abs_err=err, ms=ms, ms_batch=ms_batch,
               plain_ms=time_ms(plain, reps=min(reps, 5)),
               bound_ms=b_ms, bound_by=b_by, library_ms=None, gflop=flops / 1e9,
               tflops=flops / ms / 1e9, mbytes=nbytes / 1e6)
    emit({"kernel_check": res})
    return res


def step_inputs(spec, N, F_in, seed, device):
    p = random_model(spec.with_(ivf_K=0), seed, device).step(0)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((N, spec.D), generator=g, device=device)
    xh = x.repeat_interleave(F_in, 0) + 0.7 * torch.randn((N * F_in, spec.D), generator=g,
                                                           device=device)
    return p, x, xh


def check_rebuild(label, spec, p, dists, xh, A, F_in, reps=20) -> dict:
    N = dists.shape[0]
    F_out = min(spec.B, F_in * A)
    esize = 2 if spec.compute_dtype == "bfloat16" else 4

    def compare(got, want):
        (xhat, codes, parents), (xhat_p, codes_p, parents_p) = got, want
        check(torch.equal(codes, codes_p) and torch.equal(parents, parents_p),
              f"select_rebuild {label}: codes or parents differ from the plain version")
        e = (xhat - xhat_p).abs()
        check(e.max() <= 5e-2 and e.mean() <= 1e-3,
              f"select_rebuild {label}: xhat max err {e.max()}, mean {e.mean()}")
        return e.max().item()

    return kernel_check(
        "select_rebuild", label, spec,
        lambda: kernels.select_rebuild(spec, dists, xh, p, A, F_out),
        lambda: kernels.select_rebuild_plain(spec, dists, xh, p, A, F_out), compare,
        rebuild_work(spec, N, F_in, A, F_out, esize, spec.concat_rank), reps=reps, N=N,
        F_in=F_in, A=A, F_out=F_out)


def check_selected(label, spec, N, F_in, A, seed, device, external=False, reps=20) -> dict:
    """Selected scores (and, for the in-kernel route, select-rebuild on its
    output) at one shape; external=True feeds the packed exact top-A of the
    f32 substep distances (the external-vals route)."""
    esize = 2 if spec.compute_dtype == "bfloat16" else 4
    p, x, xh = step_inputs(spec, N, F_in, seed, device)
    vals = None
    if external:
        r = x.repeat_interleave(F_in, 0) - xh
        sub = p.sub_codebook
        ids = torch.arange(spec.K, device=device)[None, :]
        packed = kernels.pack_ids_f32((sub * sub).sum(1) - 2.0 * (r @ sub.T), ids)
        vals = torch.sort(packed, dim=1, stable=True).values[:, :A].contiguous()
    res = {"selected_scores": kernel_check(
        "selected_scores", label, spec,
        lambda: kernels.selected_scores(spec, x, xh, p, A, vals=vals),
        lambda: kernels.selected_scores_plain(spec, x, xh, p, A, vals=vals),
        lambda got, want: compare_scores(f"selected_scores {label}", got, want,
                                         spec.compute_dtype),
        selected_work(spec, N, F_in, A, esize, external), reps=reps, N=N, F_in=F_in, A=A,
        route="external vals" if external else "in-kernel top-A",
        table="lean" if spec.fast else "folded")}
    if not external:
        dists = kernels.selected_scores_plain(spec, x, xh, p, A).reshape(N, F_in * A)
        res["select_rebuild"] = check_rebuild(label, spec, p, dists, xh, A, F_in, reps)
    return res


def check_rebuild_alone(label, spec, N, F_in, A, seed, device) -> dict:
    """Select-rebuild on the packed scores of the plain selected scores."""
    p, x, xh = step_inputs(spec, N, F_in, seed, device)
    dists = kernels.selected_scores_plain(spec, x, xh, p, A).reshape(N, F_in * A)
    return check_rebuild(label, spec, p, dists, xh, A, F_in)


def check_fused(label, spec, N, F_in, A, seed, device, reps=20) -> dict:
    esize = 2 if spec.compute_dtype == "bfloat16" else 4
    p, x, xh = step_inputs(spec, N, F_in, seed, device)
    return kernel_check(
        "fused_substep_scores", label, spec,
        lambda: kernels.fused_substep_scores(spec, x, xh, p, A),
        lambda: kernels.fused_substep_scores_plain(spec, x, xh, p, A),
        lambda got, want: compare_scores(f"fused_substep_scores {label}", got, want,
                                         spec.compute_dtype),
        fused_work(spec, N, F_in, A, esize), reps=reps, N=N, F_in=F_in, A=A)


def check_candidate(label, spec, N, F_in, A, seed, device, reps=20) -> dict:
    """Candidate scores for random ids (packed for K <= 256); with a
    low-rank factor, select-rebuild on the packed output too."""
    esize = 2 if spec.compute_dtype == "bfloat16" else 4
    p, x, xh = step_inputs(spec, N, F_in, seed, device)
    x_f = x.repeat_interleave(F_in, 0)
    g = torch.Generator(device=device).manual_seed(seed + 3)
    idx = torch.randint(0, spec.K, (N * F_in, A), generator=g, device=device, dtype=torch.int32)
    pack = spec.K <= 256
    rtol = 1e-4 if spec.compute_dtype == "float32" else 1e-2

    def compare(got, want):
        if pack:
            check(torch.equal(kernels.unpack_ids(got), idx),
                  f"candidate_scores {label}: packed ids are not the given ids")
            got, want = _unpacked(got), _unpacked(want)
        torch.testing.assert_close(got, want, rtol=rtol, atol=1e-4)
        return (got - want).abs().max().item()

    res = {"candidate_scores": kernel_check(
        "candidate_scores", label, spec,
        lambda: kernels.candidate_scores(spec, x_f, xh, idx, p, pack_ids=pack),
        lambda: kernels.candidate_scores_plain(spec, x_f, xh, idx, p, pack_ids=pack), compare,
        candidate_work(spec, N * F_in, A, esize, spec.concat_rank), reps=reps, N=N,
        F_in=F_in, A=A, K=spec.K, packed=pack, concat_rank=spec.concat_rank)}
    if pack:
        dists = kernels.candidate_scores_plain(spec, x_f, xh, idx, p, pack_ids=True)
        res["select_rebuild"] = check_rebuild(label, spec, p, dists.reshape(N, F_in * A), xh,
                                              A, F_in, reps)
    return res


def device_breakdown(fn) -> dict:
    """Device time by kernel over one call of ``fn``, from torch.profiler,
    with the call's wall time: the device's busy share is their ratio."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                top=[[name[:80], ms, n] for name, (ms, n) in top])


def beam_launches(launches: dict) -> dict:
    """``launches`` without the IVF step's kernels, which k-means, the RQ
    bootstrap and OPQ launch as well (``ivf_launches`` counts them on the
    encodes)."""
    return {k: v for k, v in launches.items() if k not in kernels.NEAREST_KERNELS}


def ivf_launches(spec, chunks: int, batch: int, device) -> dict:
    """The IVF step's launches in ``chunks`` encode chunks of ``batch``
    rows: its kernel once a chunk, and the merge where the plan splits the
    book; none without the IVF step."""
    if not spec.ivf_in_use:
        return {k: 0 for k in kernels.NEAREST_KERNELS}
    merge = kernels.nearest_plan(batch, spec.ivf_K, kernels._sm_count(device)) > 1
    return {"nearest": chunks, "nearest_merge": chunks * merge}


def run_path(label, spec, params, x_raw, batch, device, scorer, noise, mse_bound, min_agree):
    """A main path: encode_chunked then decode, with the launch counts read
    around it; then its checks against decode and the exact profile (on
    the first chunk).
    ``scorer`` is the scoring kernel of every MLP step; select-rebuild
    follows it where the ids are packed (K <= 256)."""
    n = len(x_raw)
    encode_chunked(params, spec, x_raw[:batch], batch=batch)  # warm-up chunk
    torch.cuda.synchronize()

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    codes = encode_chunked(params, spec, x_raw, batch=batch)
    t1 = time.perf_counter()
    codes_d = torch.from_numpy(codes).to(device)
    xdec = decode_raw(params, spec, codes_d)  # checked below; warms decode up
    decode_rates = []
    for _ in range(DECODE_WINDOWS):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(DECODE_REPS):
            decode_raw(params, spec, codes_d)
        torch.cuda.synchronize()
        decode_rates.append(n * DECODE_REPS / (time.perf_counter() - t2))
    launches = dict(kernels.LAUNCHES)

    per_step = spec.n_mlp_steps * -(-n // batch)
    used = {scorer} | ({"select_rebuild"} if spec.K <= 256 else set())
    want = {k: per_step if k in used else 0 for k in kernels.LAUNCHES}
    want.update(ivf_launches(spec, -(-n // batch), batch, device))
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    check(codes.shape == (spec.M_ivf, n) and codes.min() >= 0, f"{label}: bad codes")
    check(bool(torch.isfinite(xdec).all()), f"{label}: decode is not finite")

    # encode's own xhat against decode of its codes (bf16 tolerance)
    sub = slice(0, batch)
    x_sub = torch.from_numpy(x_raw[sub]).to(device)
    x_n = (x_sub - params.data_mean) / params.data_std
    codes_e, xhat_e, _ = encode(params, spec, x_n)
    check(torch.equal(codes_e.cpu(), torch.from_numpy(codes[:, sub])),
          f"{label}: encode of a chunk differs from encode_chunked")
    xhat_dec = decode(params, spec, codes_e)
    rel = (((xhat_e - xhat_dec) ** 2).mean() / (xhat_dec ** 2).mean()).item()
    check(rel <= 1e-4, f"{label}: encode xhat vs decode relative MSE {rel}")

    # the profile against the exact (f32, plain) profile
    spec_x = spec.with_(pallas=False, fast=False, compute_dtype="float32")
    codes_x, _, _ = encode(params, spec_x, x_n)
    mse_x = ((x_sub - decode_raw(params, spec_x, codes_x)) ** 2).sum(-1).mean().item()
    mse_p = ((x_sub - decode_raw(params, spec, codes_e)) ** 2).sum(-1).mean().item()
    agree = (codes_e == codes_x).float().mean().item()
    check(mse_bound is None or mse_p <= mse_bound * mse_x,
          f"{label}: MSE {mse_p} > {mse_bound} x exact {mse_x}")
    check(min_agree is None or agree >= min_agree,
          f"{label}: code agreement with exact {agree} < {min_agree}")

    # where one chunk's and one decode's time goes (the counts are read above already)
    chunk = x_raw[:batch]
    breakdown = device_breakdown(lambda: encode_chunked(params, spec, chunk, batch=batch))
    if spec.compute_dtype == "float32":  # the f32 kernels lead the chunk's profile
        names = [name for name, _, _ in breakdown["top"]]
        check(F32_TILED[scorer] in names[0], f"{label}: top kernel {names[0]}")
        check(spec.K > 256 or any(F32_TILED["select_rebuild"] in n for n in names),
              f"{label}: no {F32_TILED['select_rebuild']} in the profile's top {names}")
    decode_breakdown = device_breakdown(lambda: decode_raw(params, spec, codes_d))
    res = dict(path=label, n=n, batch=batch, noise=noise, launches=launches, breakdown=breakdown,
               decode_breakdown=decode_breakdown,
               encode_vec_s=n / (t1 - t0), decode_vec_s=statistics.median(decode_rates),
               decode_window_vec_s=decode_rates, encode_s=t1 - t0, mse_profile=mse_p,
               mse_exact=mse_x, mse_ratio=mse_p / mse_x, code_agreement=agree,
               exact_rows=len(x_sub), xhat_vs_decode_rel_mse=rel)
    emit({"path": res})
    return res


def run_main(argv) -> str:
    """``python -m qinco_torch`` on ``argv``, in this process; its log goes
    to stderr and is returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = qinco_main(argv)
    log = buf.getvalue()
    sys.stderr.write(log)
    check(rc == 0, f"qinco_torch {argv[0]} returned {rc}")
    return log


def _found(pattern: str, log: str) -> list[str]:
    got = re.findall(pattern, log)
    check(bool(got), f"no {pattern!r} in the log")
    return got


GEMM = re.compile(r"gemm|cutlass|xmma", re.I)
OPTIMIZER = re.compile(r"adam|multi_tensor", re.I)


def step_breakdown(fn) -> dict:
    """Device ms of one call of ``fn`` by kind, from torch.profiler: the
    encode kernels, cuBLAS GEMMs (the losses' forward and backward, the
    encode's step-0 distances), the optimizer, and the rest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = dict(encode_kernels=0.0, gemm=0.0, optimizer=0.0, rest=0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name
        kind = ("encode_kernels" if "selected_scores" in name or "select_rebuild" in name
                else "gemm" if GEMM.search(name) else "optimizer" if OPTIMIZER.search(name)
                else "rest")
        kinds[kind] += e.time_range.elapsed_us() / 1e3
    return dict(wall_ms=wall * 1e3, device_busy_ms=sum(kinds.values()), by_kind_ms=kinds)


def _clone(params: QincoParams) -> QincoParams:
    steps = StepParams(*(None if a is None else a.detach().clone() for a in params.steps))
    return QincoParams(params.codebook0.detach().clone(), steps,
                       params.data_mean.detach().clone(), params.data_std.detach().clone())


@contextlib.contextmanager
def plain_gathers(on: bool):
    """With ``on``, the losses' codebook gathers are plain ``table[ids]``
    (as before the deterministic backward), for a timing beside them."""
    saved = qinco_model.gather_rows
    if on:
        qinco_model.gather_rows = lambda table, ids: table[ids.long()]
    try:
        yield
    finally:
        qinco_model.gather_rows = saved


def train_log(log: str) -> dict:
    """What a ``task=train`` run logged: the RQ bootstrap's MSE and seconds,
    the validation MSEs, the steps and seconds of training, every loss."""
    rq_mse, rq_s = map(float, _found(r"RQ init train MSE=(\S+) \((\S+)s\)", log)[0])
    val = [float(v) for v in _found(r"Validation metrics: \[\[MSE=([^\]]+)\]\]", log)]
    steps, train_s = _found(r"Training done: (\d+) steps in (\S+)s", log)[0]
    losses = [float(v) for v in _found(r"train loss (\S+)", log)]
    for line in _found(r"All losses: \[\[(.*)\]\]", log):
        losses += [float(kv.split("=")[1]) for kv in line.split(" ; ")]
    return dict(rq_mse=rq_mse, rq_s=rq_s, val=val, steps=int(steps), train_s=float(train_s),
                losses=losses)


def check_train_run(label, spec, run, launches, steps, val_rows) -> None:
    """A parity ``task=train`` run: its step count, one selected-scores and
    one select-rebuild launch per MLP step of every step and validation
    batch (none of the other beam-step kernels; the RQ bootstrap's k-means
    launches the IVF step's, which are not counted here), finite losses, a
    falling validation MSE."""
    val = run["val"]
    per_batch = spec.n_mlp_steps * (run["steps"] + len(val) * -(-val_rows // TRAIN_BATCH))
    launches = beam_launches(launches)
    want = {k: per_batch if k in ("selected_scores", "select_rebuild") else 0 for k in launches}
    check(run["steps"] == steps, f"{label}: {run['steps']} steps, expected {steps}")
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    check(all(math.isfinite(v) for v in run["losses"] + val),
          f"{label}: a loss is not finite: {run['losses']}")
    check(val[-1] < val[0], f"{label}: validation MSE {val[0]} -> {val[-1]} did not fall")


def eval_checkpoint(label, val_path: Path, model_path: Path, common, val) -> float:
    """``task=eval`` of a checkpoint on the held-out rows gives the
    checkpoint's validation MSE (rtol 1e-4); returns it."""
    eval_log = run_main(["task=eval", f"db={val_path}", f"model={model_path}", *common])
    eval_mse = float(_found(r"Test metrics: \[\[MSE=([^\]]+)\]\]", eval_log)[0])
    best = min(val[1:])  # the checkpoint's epoch
    check(abs(eval_mse - best) <= 1e-4 * best,
          f"{label}: eval of the checkpoint gives MSE {eval_mse}, its validation MSE was {best}")
    return eval_mse


def fresh_step(trained, spec, cfg, xb, wb):
    """One train step on ``xb`` from a copy of ``trained`` and a fresh
    optimizer, as a function that returns the step's output."""
    p = _clone(trained)
    opt = tts.build_optimizer(cfg, p, spec)
    step = tts.make_train_step(spec, opt, cfg.grad_clip)
    mstate = init_model_state(spec, device=xb.device)
    return lambda: step(p, mstate, xb, wb)[2]


def train_phase(seed: int, device, workdir: Path) -> dict:
    """The train phase (item 5 of the docstring); returns its JSON record
    with the main run's kernel launches."""
    spec = spec_of("qinco2-S")
    data = synthetic_data(spec, random_model(spec, seed, device), TRAIN_ROWS + TRAIN_VAL,
                          seed + 5, NOISE)
    data_path, val_path = workdir / "train.npy", workdir / "val.npy"
    model_path = workdir / "model.npz"
    np.save(data_path, data)
    np.save(val_path, data[TRAIN_ROWS:])  # the rows that training holds out
    common = ["encode_profile=parity", f"batch={TRAIN_BATCH}", "verbose=false"]
    # epochs=1 and stop_patience=0: the cosine run stops after epoch
    # epochs + stop_patience, so 2 epochs
    train_args = ["task=train", "model_args=qinco2-S", f"trainset={data_path}",
                  f"output={model_path}", f"ds.valset={TRAIN_VAL}", f"ds.loop={TRAIN_LOOP}",
                  "epochs=1", "scheduler.stop_patience=0", f"seed={seed}", *common]

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    log = run_main(train_args)
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    run = train_log(log)
    steps, val = run["steps"], run["val"]
    check_train_run("train", spec, run, launches, 2 * TRAIN_LOOP // TRAIN_BATCH, TRAIN_VAL)

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    eval_mse = eval_checkpoint("train", val_path, model_path, common, val)
    for k, v in kernels.LAUNCHES.items():
        launches[k] += v

    # From the checkpoint's weights, on its first batch: one parity step's
    # launches, one step under parity against one under exact, and timings.
    trained = load_checkpoint(model_path, spec, device=device)["params"]
    cfg = load_config(["model_args=qinco2-S"])
    xb = torch.from_numpy(data[:TRAIN_BATCH]).to(device)
    wb = torch.ones((TRAIN_BATCH,), device=device)

    step_p = fresh_step(trained, spec, cfg, xb, wb)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    out_p = step_p()
    torch.cuda.synchronize()
    per_step = dict(kernels.LAUNCHES)
    check(per_step == {k: spec.n_mlp_steps if k in ("selected_scores", "select_rebuild") else 0
                       for k in per_step}, f"train step: launches {per_step}")
    out_x = fresh_step(trained, spec.with_(pallas=False, fast=False, compute_dtype="float32"),
                       cfg, xb, wb)()
    loss_ratio = float(out_p.total_loss) / float(out_x.total_loss)
    agree = (out_p.codes == out_x.codes).float().mean().item()
    check(loss_ratio <= 1.01, f"train step: parity loss / exact loss {loss_ratio} > 1.01")
    check(agree >= 0.9, f"train step: parity codes agree with exact on {agree} < 0.9")
    # the step, and the same step with plain autograd gathers (whose
    # backward sums by atomic adds), in turns: new, plain, plain, new
    turns = []
    for plain in (False, True, True, False):
        with plain_gathers(plain):
            turns.append(time_ms(step_p, reps=10))
    step_ms = (turns[0] + turns[3]) / 2
    breakdown = step_breakdown(step_p)
    with plain_gathers(True):
        plain_breakdown = step_breakdown(step_p)
    repeat = repeated_train_runs(seed, workdir, data_path)

    res = dict(rows=TRAIN_ROWS, val_rows=TRAIN_VAL, rows_per_epoch=TRAIN_LOOP,
               batch=TRAIN_BATCH, steps=steps, rq_init_s=run["rq_s"], rq_train_mse=run["rq_mse"],
               train_phase_s=run["train_s"], train_vec_s=steps * TRAIN_BATCH / run["train_s"],
               run_s=run_s, val_mse=val, eval_mse=eval_mse, step_ms=step_ms,
               step_ms_turns=turns, step_ms_plain_gathers=(turns[1] + turns[2]) / 2,
               launches_per_step=per_step, step_breakdown=breakdown,
               step_breakdown_plain_gathers=plain_breakdown,
               parity_vs_exact_loss_ratio=loss_ratio, parity_vs_exact_code_agreement=agree,
               repeat=repeat, launches=launches)
    emit({"train": res})
    return res


def deep_kernel_checks(N: int, seed: int, device) -> None:
    """The kernels at qinco2-L (L=16, de=dh=384: the JAX package's blocked
    form of selected scores, past L=4), each against its plain version:
    selected scores (in-kernel top-A) with select-rebuild on its output,
    and fused-substep scores, at bf16 and f32; selected scores with
    external vals (``pallas=true``, f32); candidate scores at K=1024, bf16
    and f32.  ``DEEP_REPS`` timed calls each."""
    spec, speed = spec_of("qinco2-L"), spec_of("qinco2-L", profile="speed")
    kw = dict(seed=seed, device=device, reps=DEEP_REPS)
    check_selected("qinco2-L", spec, N, spec.B, spec.A, **kw)
    check_fused("qinco2-L speed", speed, N, spec.B, spec.A, **kw)
    check_selected("qinco2-L fast_encode=true pallas=true (f32, in-kernel top-A)",
                   spec_of("qinco2-L", "pallas=true", "fast_encode=true", profile=None), N,
                   spec.B, spec.A, **kw)
    check_fused("qinco2-L speed f32", speed.with_(compute_dtype="float32"), N, spec.B, spec.A,
                **kw)
    check_selected("qinco2-L pallas=true (f32, folded table)",
                   spec_of("qinco2-L", "pallas=true", profile=None), N, spec.B, spec.A,
                   external=True, **kw)
    for dtype, suffix in (("bfloat16", ""), ("float32", " f32")):
        check_candidate(f"qinco2-L widths K=1024{suffix}",
                        spec_of("qinco2-L", "K=1024").with_(compute_dtype=dtype), N, spec.B,
                        spec.A, **kw)


def wide_kernel_checks(N: int, seed: int, device) -> None:
    """B2 and B3 at the qinco2-L widths and D = ``WIDE_D``, each against its
    plain version: selected scores with the in-kernel top-A (select-rebuild
    on its output) and with external vals (``fused_topa=false``), at a
    normal step and at the IVF first step, after checking that each plan
    takes D in column passes.  ``DEEP_REPS`` timed calls each."""
    topa = spec_of("qinco2-L", D=WIDE_D)
    vals = spec_of("qinco2-L", "fused_topa=false", D=WIDE_D)
    for F_in, A, step in ((topa.B, topa.A, ""), (1, max(topa.B, topa.A), " IVF first step")):
        for spec, external in ((topa, False), (vals, True)):
            p, _, xh = step_inputs(spec, N, F_in, seed, device)
            plan = kernels._selected_launch_plan(spec, xh, kernels._selected_weights(spec, p), A,
                                                 not external)
            label = f"qinco2-L D={WIDE_D}{step}"
            check(plan.d_passes > 1, f"selected_scores {label}: one pass over D ({plan})")
            if not external:
                F_out = min(spec.B, F_in * A)
                reb = kernels.rebuild_plan(N, F_in * A, F_out, spec.D, spec.de, spec.dh, spec.de,
                                           bf16=True, low_rank=False, stages=3 + 2 * spec.L,
                                           sms=kernels._sm_count(device))
                check(reb.d_passes > 1, f"select_rebuild {label}: one pass over D ({reb})")
            check_selected(label + (" (external vals)" if external else ""), spec, N, F_in, A,
                           seed, device, external=external, reps=DEEP_REPS)


def ivf_kernel_checks(seed: int, device) -> dict:
    """The IVF step 0's kernel (``chunked_argmin`` on the card, csrc/nearest.cu)
    against the plain loop it replaces (``chunked_argmin_plain``: a cuBLAS
    product and a row min a 65,536-row slice) at the encode's chunk,
    N = 1024 rows on a 2^20-row book, at D = 128 (qinco2-S) and
    D = ``WIDE_D``, with the tolerances of ``tests/test_torch_nearest.py``:
    codes equal but at near ties, distances within ``IVF_RTOL`` of the size
    of their terms.  Checks its launches (the kernel and the merge) and
    that the call allocates no (N, 65,536) distance tile; times a call and
    the plain loop (CUDA events) against the bound by f32 operations.  One
    ``{"ivf_step": ...}`` line; returns the D = 128 record."""
    N, K = 1024, 1 << 20
    res = []
    for D in (128, WIDE_D):
        g = torch.Generator(device=device).manual_seed(seed + D)
        x = torch.randn((N, D), generator=g, device=device)
        book = torch.randn((K, D), generator=g, device=device)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = {k: kernels.LAUNCHES[k] for k in kernels.NEAREST_KERNELS}
        idx, dist = chunked_argmin(x, book)
        torch.cuda.synchronize()
        alloc = torch.cuda.max_memory_allocated() - base
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.NEAREST_KERNELS}
        label = f"IVF step N={N} K=2^20 D={D}"
        check(launched == {"nearest": 1, "nearest_merge": 1}, f"{label}: launches {launched}")
        check(alloc < 4 * N * 65536 // 64, f"{label}: the call allocated {alloc} bytes")
        want, _ = chunked_argmin_plain(x, book)
        c, xd = book[idx].double(), x.double()
        cc, xc = (c * c).sum(-1), (xd * c).sum(-1)
        exact, size = cc - 2 * xc, cc + 2 * xc.abs()
        cw = book[want].double()
        exact_w = (cw * cw).sum(-1) - 2 * (xd * cw).sum(-1)
        differ = idx != want
        check(bool(((exact - exact_w).abs()[differ] <= IVF_RTOL * size[differ]).all()),
              f"{label}: a code differs from the plain loop's off a near tie")
        err = ((dist.double() - exact).abs() / size).max().item()
        check(err <= IVF_RTOL, f"{label}: distance error {err} of its terms' size")
        flops = 2.0 * N * K * D
        b_ms, b_by = bound_ms(flops, 4.0 * (N * D + K * D) + 12.0 * N, "float32")
        ms = time_ms(lambda: chunked_argmin(x, book))
        res.append(dict(N=N, K=K, D=D, splits=kernels.nearest_plan(N, K, kernels._sm_count(device)),
                        launches=launched, alloc_bytes=alloc, codes_differ=int(differ.sum()),
                        max_rel_err=err, ms=ms, ms_batch=batch_ms(lambda: chunked_argmin(x, book)),
                        plain_ms=time_ms(lambda: chunked_argmin_plain(x, book), reps=5),
                        bound_ms=b_ms, bound_by=b_by, pct_of_bound=100 * b_ms / ms,
                        tflops=flops / ms / 1e9, design=IVF_DESIGN))
        del x, book
        torch.cuda.empty_cache()
    emit({"ivf_step": res})
    return res[0]


def load_script(name: str):
    """A script of ``scripts/`` as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def exact_excess(got, plain, exact) -> dict:
    """How far the (unpacked) values ``got`` lie from the sums exact to
    float64 (``breakdown.nodist_exact``, ``breakdown.mlponly_exact``), as
    shares of the bounds of ``tests/torch_exact.py``'s rule: the max
    |got - exact| against twice the plain version's max |plain - exact|
    plus one bf16 unit of the largest |exact|, the mean against four times
    the plain version's mean plus one bf16 unit of the mean |exact|.  Both
    <= 1: as near the exact sums as the plain version, up to those
    multiples."""
    e_got, e_plain = (got - exact).abs(), (plain - exact).abs()
    unit = 2.0 ** -8
    max_bound = 2.0 * e_plain.max() + unit * exact.abs().max()
    mean_bound = 4.0 * e_plain.mean() + unit * exact.abs().mean()
    return {"max_share": (e_got.max() / max_bound).item(),
            "mean_share": (e_got.mean() / mean_bound).item()}


def compare_nodist(label, got, want, exact) -> dict:
    """``nodist`` packs |sum(out + cand)| + 1 with slot a's id a: the ids
    equal, and the values within ``exact_excess``'s bounds.  Its signed
    sum carries a bf16 rounding flip of an early block on through every
    later term, which the distance's squares would damp, and the kernel
    and the plain version flip in their own places: so both are held
    against the exact sums, not one against the other."""
    check(torch.equal(kernels.unpack_ids(got), kernels.unpack_ids(want)), f"{label}: ids")
    excess = exact_excess(_unpacked(got), _unpacked(want), exact)
    check(max(excess.values()) <= 1.0, f"{label}: further from the exact sums than {excess}")
    return excess


def nodist_faults(spec, x, xh, p, A, want, exact) -> dict:
    """The ``nodist`` kernel run with two faults planted through its inputs
    (its last FFN block skipped: that block's down-projection zeroed, so
    the residual passes h on; the codeword not added to the output: the
    QINCo1 flag), each held by ``exact_excess`` against the sound plain
    version and the exact sums: each must fail the bound, or the check
    that passes the sound kernel could pass a wrong one."""
    skipped = p._replace(ffn_down=torch.cat([p.ffn_down[:-1], 0 * p.ffn_down[-1:]]))
    res = {"last_ffn_block_skipped": breakdown.ktopa_variant(spec, x, xh, skipped, A, "nodist"),
           "cand_not_added": breakdown.ktopa_variant(spec.with_(qinco1_mode=True), x, xh, p, A,
                                                     "nodist")}
    res = {name: exact_excess(_unpacked(got), _unpacked(want), exact)
           for name, got in res.items()}
    for name, excess in res.items():
        check(max(excess.values()) > 1.0, f"nodist: the fault {name} passes the bound: {excess}")
    return res


def compare_sel(label, got, want, spec, x, xh, p, F_in) -> torch.Tensor:
    """B4's bin minima (f32 sums in another order on each side): ids equal
    wherever the bin's two least substep distances are more than 1e-3
    apart; returns where the ids agree."""
    w = kernels._fused_weights(spec, p)
    packed = kernels._substep_packed(spec, x.repeat_interleave(F_in, 0) - xh, w.sub_t, w.cn2)
    two = _unpacked(packed).view(len(xh), spec.A, -1).sort(dim=2).values[..., :2]
    same = kernels.unpack_ids(got) == kernels.unpack_ids(want)
    check(bool(same[two[..., 1] - two[..., 0] > 1e-3].all()),
          f"{label}: ids differ where the bin's minimum is distinct")
    return same


def compare_sums(label, got, want, mass) -> float:
    """Signed f32 sums in another order on each side (``dsub``'s bins of
    packed values, ``bw``'s tile columns): within rtol 1e-4 of the value
    plus 1e-5 of the summed mass ``mass`` (the sum of |terms|: a sum that
    cancels keeps the rounding of its terms, not of its value)."""
    err = (got - want).abs()
    check(bool((err <= 1e-4 * want.abs() + 1e-5 * mass).all()),
          f"{label}: max |kernel - plain| {err.max().item()} beyond the sums' rounding")
    return err.max().item()


def variant_checks(seed: int, device, tkv) -> dict:
    """The V4-V8 kernels of ``kernel_variants.py`` at the script's N = 4096,
    each against its plain version on the card: ``dsub`` and ``bw`` (f32 and
    bf16 input at rows 512) as ``compare_sums`` says, ``noop`` bit for bit,
    ``fullopt`` and ``selcat`` at B2's bf16 limits, ``mlponly`` (unpacked,
    every slot of a row equal) against sums exact to float64 with one
    planted fault (its last FFN block skipped: the spec's L one less) that
    must fail, and production B4 on the script's operands, which perbin
    and sgfetch launch, at B4's limits.  Returns each kernel's numbers."""
    spec, A = tkv.SPEC, tkv.SPEC.A
    case = tkv.Case(tkv.N, device, seed)
    x, xh, p = case.x, case.xh, case.p
    Wt = breakdown.variant_table(spec, p).shape[1]
    res = {}

    def record(label, err, plain, work, library=None, **extra):
        b_ms, b_by = bound_ms(*work, "bfloat16")
        res[label] = dict(max_abs_err=err, plain_ms=time_ms(plain, reps=3, warmup=1),
                          bound_ms=b_ms, bound_by=b_by,
                          library_ms=time_ms(library) if library else None,
                          **extra)

    for cut in ("dsub", "mlponly", "fullopt"):
        label = f"fused_cut:{cut}"
        got = breakdown.fused_cut(spec, x, xh, p, A, cut)
        plain = lambda: breakdown.fused_cut_plain(spec, x, xh, p, A, cut)  # noqa: E731
        want, extra = plain(), {}
        if cut == "dsub":
            w = kernels._fused_weights(spec, p)
            packed = kernels._substep_packed(spec, x.repeat_interleave(spec.B, 0) - xh, w.sub_t,
                                             w.cn2)
            mass = _unpacked(packed).abs().view(len(xh), A, -1).sum(2)
            err = compare_sums(label, got, want, mass)
        elif cut == "mlponly":
            check(bool((got == got[:, :1]).all()), f"{label}: the slots of a row differ")
            exact = breakdown.mlponly_exact(spec, x, xh, p, A)
            excess = exact_excess(got, want, exact)
            check(max(excess.values()) <= 1.0, f"{label}: further from the exact sums: {excess}")
            fault = exact_excess(breakdown.fused_cut(spec.with_(L=spec.L - 1), x, xh, p, A, cut),
                                 want, exact)
            check(max(fault.values()) > 1.0, f"{label}: the fault passes the bound: {fault}")
            extra = dict(exact_check=dict(kernel=excess, last_ffn_block_skipped=fault))
            err = (got - want).abs().max().item()
        else:
            err = compare_scores(label, got, want, "bfloat16")
        record(label, err, plain, variant_work(spec, tkv.N, spec.B, A, cut, Wt), **extra)
    vals = tkv.external_vals(x, xh, p)
    plain = lambda: breakdown.selcat_plain(spec, x, xh, p, vals)  # noqa: E731
    err = compare_scores("selcat", breakdown.selcat(spec, x, xh, p, vals), plain(), "bfloat16")
    record("selcat", err, plain, variant_work(spec, tkv.N, spec.B, A, "selcat", Wt))
    for name, kind, data, rows in (("noop", "noop", xh, 256),
                                   ("bw_f32", "bw", case.bw["bw_f32"], 512),
                                   ("bw_bf16", "bw", case.bw["bw_bf16"], 512)):
        label = f"stream_probe:{name}"
        got = breakdown.stream_probe(data, kind, rows, A)
        plain = lambda: breakdown.stream_probe_plain(data, kind, rows, A)  # noqa: E731
        want = plain()
        # the one PyTorch call of the same function (bw's sums without the
        # broadcast to 8 rows, where rows divide NF)
        if kind == "noop":
            check(torch.equal(got, want), f"{label}: not 2·xh[:, :A]")
            err = 0.0
            library = lambda: torch.mul(data[:, :A], 2.0)  # noqa: E731
        else:
            mass = breakdown.stream_probe_plain(data.float().abs(), "bw", rows)
            err = compare_sums(label, got, want, mass)
            tiles = data.view(-1, rows, data.shape[1]) if len(data) % rows == 0 else None
            library = tiles is not None and (lambda: tiles.sum(1, dtype=torch.float32))
        record(label, err, plain, probe_work(data, kind, rows, A), library, rows=rows)
    # production B4 on the script's operands: what perbin and sgfetch launch
    plain = lambda: kernels.fused_substep_scores_plain(spec, x, xh, p, A)  # noqa: E731
    err = compare_scores("B4 (perbin, sgfetch)",
                         kernels.fused_substep_scores(spec, x, xh, p, A), plain(), "bfloat16")
    record("b4_script", err, plain, fused_work(spec, tkv.N, spec.B, A, 2, out_proj=True))
    return res


def selected_ko_check(tkv, seed: int, device) -> dict:
    """B2' (external vals, the lean table) as ``selected-ko`` runs it, on
    the script's operands: the kernel against its plain version at B2's
    bf16 limits, the plain version's ms and the bound."""
    case = tkv.Case(tkv.N, device, seed)
    spec, vals = tkv.SPEC.with_(fused_substep=False), case.vals()
    args = (spec, case.x, case.xh, case.p, spec.A, vals)
    plain = lambda: kernels.selected_scores_plain(*args)  # noqa: E731
    err = compare_scores("selected-ko", kernels.selected_scores(*args), plain(), "bfloat16")
    b_ms, b_by = bound_ms(*selected_work(spec, tkv.N, spec.B, spec.A, 2, external=True),
                          "bfloat16")
    return dict(max_abs_err=err, plain_ms=time_ms(plain, reps=3, warmup=1), bound_ms=b_ms,
                bound_by=b_by)


def breakdown_phase(seed: int, device) -> dict:
    """The phase-breakdown kernels (``qinco_torch.ops.breakdown``): B2's
    kernels (``kernels.KTOPA_KERNELS``) at the script's N = 1024 and B4's
    cuts, ``selcat`` and the streaming probes at N = 4096, on the inputs of
    ``scripts/torch_ktopa_breakdown.py`` and
    ``scripts/torch_kernel_variants.py`` from ``seed``.  First each kernel
    against its plain version (B2's bf16 limits; ``nodist`` and ``sel`` as
    their compare functions say; ``sel+fetch`` rtol 1e-2 where the
    winners agree; the V4-V8 kernels as ``variant_checks`` says); then the
    slice's path: both entry scripts' ``run`` with the counts at 0 (B2's
    production and kernels; every ``--variants`` name of
    ``kernel_variants.py``, ``BREAKDOWN_ITERS`` calls of each timed variant
    back to back), every kernel launched.  One ``breakdown`` line: each
    variant's ms and bound, B2's split (extraction = full - noextract,
    fetch = noextract - mlponly, distance epilogue = mlponly - nodist, MLP
    = nodist - shell, and the shell) in ms and as shares of ``full``,
    ``tournament`` against ``full``, and B4's: its selection (``sel``),
    fetch (``sel+fetch`` - ``sel``), the bin minimum (``sel`` - ``dsub``),
    the stand-in MLP chain on all pairs (``mlponly``), the whole stand-in
    pipeline (``fullopt``) as shares of its production launch, and the
    streaming floors (``noop``, ``bw``) against ``sel``.  Returns each
    kernel's numbers for the summary line and the launches."""
    tkb, tkv = load_script("torch_ktopa_breakdown"), load_script("torch_kernel_variants")
    res = {}
    kspec, A = tkb.SPEC, tkb.SPEC.A
    kw = tkb.make_inputs(seed)
    x, xh = (torch.from_numpy(kw[k]).to(device) for k in ("x", "xh"))
    p = tkb.step_params(kw, device)
    for mode in kernels.KTOPA_KERNELS:
        label = f"ktopa_variant:{mode}"
        got = breakdown.ktopa_variant(kspec, x, xh, p, A, mode)
        plain = lambda: breakdown.ktopa_variant_plain(kspec, x, xh, p, A, mode)  # noqa: E731
        want = plain()
        extra = {}
        if mode == "nodist":
            exact = breakdown.nodist_exact(kspec, x, xh, p, A)
            extra = dict(exact_check=dict(kernel=compare_nodist(label, got, want, exact),
                                          faults=nodist_faults(kspec, x, xh, p, A, want, exact)))
            err = (_unpacked(got) - _unpacked(want)).abs().max().item()
        else:
            err = compare_scores(label, got, want, "bfloat16")
        b_ms, b_by = bound_ms(*ktopa_work(kspec, tkb.N, kspec.B, A, mode), "bfloat16")
        res[label] = dict(max_abs_err=err, plain_ms=time_ms(plain, reps=3, warmup=1),
                          bound_ms=b_ms, bound_by=b_by, **extra)
    res["ktopa_variant:full"]["aliases"] = sorted(kernels.KTOPA_ALIASES)
    fspec, A = tkv.SPEC, tkv.SPEC.A
    kw = tkv.make_inputs(seed)
    x, xh = (torch.from_numpy(kw[k]).to(device) for k in ("x", "xh"))
    p = tkv.step_params(kw, device)
    same = None
    for cut in ("sel", "sel+fetch"):
        label = f"fused_cut:{cut}"
        got = breakdown.fused_cut(fspec, x, xh, p, A, cut)
        plain = lambda: breakdown.fused_cut_plain(fspec, x, xh, p, A, cut)  # noqa: E731
        want = plain()
        if cut == "sel":
            same = compare_sel(label, got, want, fspec, x, xh, p, fspec.B)
            got, want = _unpacked(got), _unpacked(want)
            rtol = 1e-4
        else:  # where the winners agree
            check(same.float().mean().item() >= 0.98, f"{label}: winners agree on < 98%")
            rtol = 1e-2
        torch.testing.assert_close(got[same], want[same], rtol=rtol, atol=1e-4)
        Wt = breakdown.variant_table(fspec, p).shape[1]
        b_ms, b_by = bound_ms(*fused_cut_work(fspec, tkv.N, fspec.B, A, cut, Wt), "bfloat16")
        res[label] = dict(max_abs_err=(got[same] - want[same]).abs().max().item(),
                          plain_ms=time_ms(plain, reps=3, warmup=1), bound_ms=b_ms, bound_by=b_by)
    res["fused_cut:sel+fetch"]["aliases"] = sorted(kernels.FUSED_ALIASES)
    del got, want, x, xh
    res.update(variant_checks(seed, device, tkv))
    torch.cuda.empty_cache()

    # the slice's path: the two entry points, the counts at 0 just before
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    b2 = tkb.run(["production", *kernels.KTOPA_KERNELS], BREAKDOWN_ITERS, device=device,
                 seed=seed)
    b4 = tkv.run(["production", *(v for v in tkv.RUNS if v != "production")], BREAKDOWN_ITERS,
                 device=device, seed=seed)
    launches = dict(kernels.LAUNCHES)
    for name in (*BREAKDOWN_SOURCES, "selected_scores", "fused_substep_scores"):
        check(launches[name] > 0, f"breakdown: {name} was not launched on the slice's path")
    # variant -> (ms a call, device ms a launch), keyed without the rows
    ms2, ms4 = ({k.split("@R")[0]: (v, r["kernel_ms"].get(k)) for k, v in r["ms_per_step"].items()}
                for r in (b2, b4))
    check(all(isinstance(v, float) for v, _ in (*ms2.values(), *ms4.values())),
          f"breakdown: errors {b2['ms_per_step']} {b4['ms_per_step']}")
    timed = {"stream_probe:noop": "noop@rt256", "stream_probe:bw_f32": "bw_f32@rt512",
             "stream_probe:bw_bf16": "bw_bf16@rt512", "b4_script": "full"}
    for name in (*BREAKDOWN_SOURCES, "b4_script"):
        kind, _, variant = name.partition(":")
        call, launch = (ms2 if kind == "ktopa_variant" else ms4)[timed.get(name, variant or kind)]
        count = launches["fused_substep_scores" if name == "b4_script" else name]
        res[name].update(ms=launch, ms_call=call, launches=count)
    k2 = {v: launch for v, (_, launch) in ms2.items()}  # device ms a launch
    k4 = {v: launch for v, (_, launch) in ms4.items()}
    full = k2["full"]
    split = {"extraction": full - k2["noextract"], "fetch": k2["noextract"] - k2["mlponly"],
             "distance_epilogue": k2["mlponly"] - k2["nodist"], "mlp": k2["nodist"] - k2["shell"],
             "shell": k2["shell"]}
    prod4, sel = k4["production"], k4["sel"]
    line = {
        "card": b2["device"], "iters": BREAKDOWN_ITERS,
        "b2": {"n": b2["batch"], "ms_launch": k2, "ms_call": {v: c for v, (c, _) in ms2.items()},
               "bound_ms": {m: res[f"ktopa_variant:{m}"]["bound_ms"]
                            for m in kernels.KTOPA_KERNELS},
               "nodist_exact_check": res["ktopa_variant:nodist"]["exact_check"],
               "split_ms": split, "split_share_of_full": {k: v / full for k, v in split.items()},
               "tournament_over_full": k2["tournament"] / full,
               "perslot_over_full": k2["perslot"] / full},
        "b4": {"n": b4["batch"], "ms_launch": k4, "ms_call": {v: c for v, (c, _) in ms4.items()},
               "bound_ms": {k: v["bound_ms"] for k, v in res.items()
                            if not k.startswith("ktopa_variant")},
               "mlponly_exact_check": res["fused_cut:mlponly"]["exact_check"],
               "names": b4["names"], "checks": b4["checks"], "gb_per_s": b4["gb_per_s"],
               "selection_share": sel / prod4, "fetch_share": (k4["sel+fetch"] - sel) / prod4,
               "bin_minimum_share": (sel - k4["dsub"]) / prod4,
               "rest_share": 1 - k4["sel+fetch"] / prod4,
               "mlponly_share": k4["mlponly"] / prod4, "fullopt_share": k4["fullopt"] / prod4,
               "noop_over_sel": k4["noop@rt256"] / sel, "bw_f32_over_sel": k4["bw_f32@rt512"] / sel,
               "selcat_over_selected_ko": k4["selcat"] / k4["selected-ko"],
               "selected_ko": selected_ko_check(tkv, seed, device)},
        "launches": {k: v for k, v in launches.items() if v}}
    emit({"breakdown": line})
    return dict(kernels=res, launches=launches)


def deep_paths() -> list:
    """The qinco2-L paths, as ``main``'s path list: parity without and with
    the 2^20 IVF step 0, speed, and the parity selection at f32.

    The speed path has no MSE bound here: on random qinco2-L weights the
    16-block MLP moves each candidate far from where the substep book (a
    copy of the step's book) puts it, and the binned pre-selection loses
    more than 1.05x the exact MSE in the JAX package as in the port.
    ``scripts/torch_deep_speed_profile.py --jax --n 1024`` shows it on a
    model made here on the CPU: both packages read 1.204x, their speed
    codes agreeing on 99.3%.  ``deep_train_phase`` holds the speed
    profile to 1.05x on the trained qinco2-L checkpoint."""
    return [
        ("qinco2-L", spec_of("qinco2-L"), "selected_scores", NOISE, 1.01, DEEP_MIN_AGREE),
        ("qinco2-L IVF 2^20", spec_of("qinco2-L", "ivf_in_use=true"), "selected_scores", NOISE,
         1.01, DEEP_MIN_AGREE),
        ("qinco2-L speed", spec_of("qinco2-L", profile="speed"), "fused_substep_scores",
         SPEED_NOISE, None, None),
        ("qinco2-L fast_encode=true pallas=true (f32)",
         spec_of("qinco2-L", "pallas=true", "fast_encode=true", profile=None), "selected_scores",
         NOISE, 1.01, 0.99),
    ]


def wide_paths() -> list:
    """The qinco2-L paths at D = ``WIDE_D``, as ``deep_paths``: parity
    without and with the 2^20 IVF step 0 (the ``qinco2-L-contriever``
    benchmark cell's), B2 and B3 on their column passes.

    Their MSE bound is ``WIDE_MSE_BOUND``, not 1.01: ``run_path`` decodes
    the parity codes with the parity profile, whose bf16 rounding through
    the 16 blocks moves a decode by about 1% of its norm, and at D = 768
    that alone adds about 2% to the MSE (1.022x exact on the first chunk
    at seed 0, where the same codes decoded in f32 read 1.007x, and the
    plain versions' parity codes 1.005x)."""
    return [
        (f"qinco2-L D={WIDE_D}", spec_of("qinco2-L", D=WIDE_D), "selected_scores", NOISE,
         WIDE_MSE_BOUND, DEEP_MIN_AGREE),
        (f"qinco2-L D={WIDE_D} IVF 2^20", spec_of("qinco2-L", "ivf_in_use=true", D=WIDE_D),
         "selected_scores", NOISE, WIDE_MSE_BOUND, DEEP_MIN_AGREE),
    ]


def drive_paths(paths, n: int, batch: int, seed: int, device) -> dict:
    """``run_path`` on each of ``paths`` with its random model and ``n``
    vectors of its data; returns the launches summed over the paths."""
    launches = {k: 0 for k in kernels.LAUNCHES}
    for label, spec, scorer, noise, mse_bound, min_agree in paths:
        params = random_model(spec, seed, device)
        x_raw = synthetic_data(spec, params, n, seed, noise)
        res = run_path(label, spec, params, x_raw, batch, device, scorer, noise, mse_bound,
                       min_agree)
        for k, v in res["launches"].items():
            launches[k] += v
        del params
        torch.cuda.empty_cache()
    return launches


def deep_train_phase(seed: int, device, workdir: Path) -> dict:
    """The qinco2-L train phase (item 5 of the docstring); returns its JSON
    record with its kernel launches."""
    spec = spec_of("qinco2-L")
    data = synthetic_data(spec, random_model(spec, seed, device),
                          DEEP_TRAIN_ROWS + DEEP_TRAIN_VAL, seed + 5, NOISE)
    data_path, val_path = workdir / "train_L.npy", workdir / "val_L.npy"
    model_path = workdir / "model_L.npz"
    np.save(data_path, data)
    np.save(val_path, data[DEEP_TRAIN_ROWS:])
    common = ["encode_profile=parity", f"batch={TRAIN_BATCH}", "verbose=false"]
    train_args = ["task=train", "model_args=qinco2-L", f"trainset={data_path}",
                  f"output={model_path}", f"ds.valset={DEEP_TRAIN_VAL}",
                  f"ds.loop={DEEP_TRAIN_LOOP}", "epochs=1", "scheduler.stop_patience=0",
                  f"seed={seed}", *common]

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    log = run_main(train_args)
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    run = train_log(log)
    check_train_run("qinco2-L train", spec, run, launches, 2 * DEEP_TRAIN_LOOP // TRAIN_BATCH,
                    DEEP_TRAIN_VAL)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    eval_mse = eval_checkpoint("qinco2-L train", val_path, model_path, common, run["val"])
    for k, v in kernels.LAUNCHES.items():
        launches[k] += v

    # The checkpoint's held-out rows under parity and under speed, each as
    # a path (launch counts, xhat against decode, MSE and codes against
    # the exact profile on the first chunk).
    trained = load_checkpoint(model_path, spec, device=device)["params"]
    held = data[DEEP_TRAIN_ROWS:]
    encodes = {}
    for profile, scorer, bound, min_agree in (("parity", "selected_scores", 1.01, 0.9),
                                              ("speed", "fused_substep_scores", 1.05, None)):
        res = run_path(f"qinco2-L {profile}, trained checkpoint", spec_of("qinco2-L",
                       profile=profile), trained, held, TRAIN_BATCH, device, scorer, NOISE,
                       bound, min_agree)
        for k, v in res["launches"].items():
            launches[k] += v
        encodes[profile] = {k: res[k] for k in ("encode_vec_s", "mse_ratio", "code_agreement")}

    # ms of a parity step from the checkpoint's weights, and its device time
    cfg = load_config(["model_args=qinco2-L"])
    xb = torch.from_numpy(data[:TRAIN_BATCH]).to(device)
    step = fresh_step(trained, spec, cfg, xb, torch.ones((TRAIN_BATCH,), device=device))
    step_ms = time_ms(step, reps=5)
    res = dict(preset="qinco2-L", rows=DEEP_TRAIN_ROWS, val_rows=DEEP_TRAIN_VAL,
               rows_per_epoch=DEEP_TRAIN_LOOP, batch=TRAIN_BATCH, steps=run["steps"],
               rq_init_s=run["rq_s"], rq_train_mse=run["rq_mse"], train_phase_s=run["train_s"],
               train_vec_s=run["steps"] * TRAIN_BATCH / run["train_s"], run_s=run_s,
               val_mse=run["val"], eval_mse=eval_mse, held_out_rows=len(held),
               checkpoint_encode=encodes, step_ms=step_ms, step_breakdown=step_breakdown(step),
               launches=launches)
    emit({"train_qinco2_L": res})
    return res


def repeated_train_runs(seed: int, workdir: Path, data_path: Path) -> dict:
    """Two short training runs from one seed through ``python -m
    qinco_torch`` (the RQ bootstrap's k-means on the card, then 2 epochs
    of ``REPEAT_LOOP`` rows = 4 steps and their validation passes): the
    checkpoints' parameters and model state, and every logged loss and
    validation MSE, must be equal bit for bit."""
    runs = []
    for r in range(2):
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        out = workdir / f"repeat_{r}.npz"
        log = run_main(repeat_args(seed, data_path, out))
        steps = int(_found(r"Training done: (\d+) steps", log)[0])
        check(steps == 2 * REPEAT_LOOP // TRAIN_BATCH, f"repeat run {r}: {steps} steps")
        runs.append((checkpoint_tensors(out), logged_values(log), dict(kernels.LAUNCHES)))
    (ta, la, ka), (tb, lb, kb) = runs
    same_tensors = len(ta) == len(tb) and all(torch.equal(a, b) for a, b in zip(ta, tb))
    same_log = la == lb
    check(same_tensors, "two training runs from one seed end at different parameters")
    check(same_log, f"two training runs from one seed logged different losses: {la} vs {lb}")
    check(ka == kb, f"two training runs from one seed launched {ka} and {kb}")
    return dict(steps=2 * REPEAT_LOOP // TRAIN_BATCH, tensors=len(ta), logged=la,
                bit_identical=same_tensors and same_log, launches=ka)


def repeat_args(seed: int, data_path: Path, out: Path) -> list[str]:
    """The arguments of the repeated short training run."""
    return ["task=train", "model_args=qinco2-S", f"trainset={data_path}", f"output={out}",
            f"ds.valset={TRAIN_VAL}", f"ds.loop={REPEAT_LOOP}", "epochs=1",
            "scheduler.stop_patience=0", f"seed={seed}", "encode_profile=parity",
            f"batch={TRAIN_BATCH}", "verbose=false"]


def checkpoint_tensors(path: Path) -> list:
    """A qinco2-S checkpoint's parameters and model state, on the card."""
    ck = load_checkpoint(path, spec_of("qinco2-S"), device="cuda")
    return param_leaves(ck["params"]) + list(ck["mstate"] or [])


def logged_values(log: str) -> list[str]:
    """The losses and validation MSEs that a training run logged."""
    return re.findall(r"RQ init train MSE=\S+|train loss \S+|All losses: \[\[.*\]\]|"
                      r"Validation metrics: \[\[MSE=[^\]]+\]\]", log)


def launch(args: list[str], group: str | None = "torchrun",
           timeout: float = 300) -> tuple[str, float]:
    """``python -m torch.distributed.run --standalone --nproc_per_node=1
    <args>`` (a one-rank NCCL group over loopback); with ``group="env"``
    ``python <args>`` as rank 0 of a world of one (torchrun's variables, a
    free port on localhost); with ``group=None`` ``python <args>``.  From
    the checkout's root: (its output, which also goes to stderr; its
    seconds).  The process and its children run in their own session,
    killed whole if they outlive ``timeout``."""
    head = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1"] \
        if group == "torchrun" else []
    env = dict(os.environ)
    if group == "env":
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *head, *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True,
                            env=env)
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0]
    sec = time.perf_counter() - t0
    sys.stderr.write(out)
    check(proc.returncode == 0, f"{' '.join(head[1:2] + args[:2])} returned {proc.returncode}")
    return out, sec


def group_launches(log: str) -> dict:
    return json.loads(_found(r"Kernel launches: (\{.*\})", log)[0])


def dist_phase(seed: int, workdir: Path, repeat: dict) -> dict:
    """The distributed phase (item 8 of the docstring), on the train
    phase's data and checkpoints in ``workdir``; returns its JSON record
    with the group runs' kernel launches."""
    spec = spec_of("qinco2-S")
    data_path = workdir / "train.npy"
    res = {}
    t_phase = time.perf_counter()
    # 1. the repeated run's training under a one-rank group: the same bits
    out = workdir / "dist_train.npz"
    log, res["train_launch_s"] = launch(["-m", "qinco_torch", *repeat_args(seed, data_path, out)])
    check("Process group: 1 rank(s), mesh data=1 x model=1" in log, "train: no process group")
    launches = group_launches(log)
    check(launches == repeat["launches"],
          f"train under the group launched {launches}, the plain run {repeat['launches']}")
    ta, tb = checkpoint_tensors(out), checkpoint_tensors(workdir / "repeat_0.npz")
    check(len(ta) == len(tb) and all(torch.equal(a, b) for a, b in zip(ta, tb)),
          "training under a one-rank group ends at other parameters than without it")
    check(logged_values(log) == repeat["logged"],
          "training under a one-rank group logged other losses than without it")
    res["train_bit_identical"] = True

    # 2. encode with that checkpoint, under the group and without it, each
    # in a fresh process (so both encode timers hold the same warm-up)
    args = ["-m", "qinco_torch", "task=encode", f"db={data_path}", f"ds.db={DIST_ENCODE_ROWS}",
            f"model={out}", "encode_profile=parity", f"batch={TRAIN_BATCH}", "verbose=false"]
    log_g, res["encode_launch_s"] = launch([*args, f"output={workdir / 'dist_codes.npz'}"])
    log_p, res["encode_plain_launch_s"] = launch([*args, f"output={workdir / 'plain_codes.npz'}"],
                                                 group=None)
    check("Process group" not in log_p, "encode without the group: a process group")
    enc = group_launches(log_g)
    expect_encode_launches("encode under the group", enc, [DIST_ENCODE_ROWS], spec)
    expect_encode_launches("encode without the group", group_launches(log_p),
                           [DIST_ENCODE_ROWS], spec)
    for k, v in enc.items():
        launches[k] += v
    check(int(np.load(workdir / "dist_codes.npz")["n_parts"]) == 1, "encode: n_parts != 1")
    part_g = np.load(workdir / "dist_codes.part_0.npz")["codes"]
    part_p = np.load(workdir / "plain_codes.part_0.npz")["codes"]
    check(part_g.shape == (DIST_ENCODE_ROWS, spec.M_ivf) and np.array_equal(part_g, part_p),
          "encode: the part files under the group and without it differ")
    secs = [float(_found(r"Encoding done in \S+ \((\S+)s\)", lg)[0]) for lg in (log_g, log_p)]
    res.update(encode_rows=DIST_ENCODE_ROWS, encode_vec_s_group=DIST_ENCODE_ROWS / secs[0],
               encode_vec_s_plain=DIST_ENCODE_ROWS / secs[1], encode_parts_equal=True)

    # 3, 4. the sharded top-k and the step's cost, in a worker of a group
    wlog, res["worker_launch_s"] = launch([str(ROOT / "chip_smoke.py"), "--dist-worker",
                                           str(workdir), "--seed", str(seed)], group="env")
    res.update(json.loads(_found(r"\{\"dist_worker\": .*\}", wlog)[0])["dist_worker"])
    res["phase_s"] = time.perf_counter() - t_phase
    res["launches"] = launches
    emit({"dist": res})
    return res


def host_top(fn, n: int = 10) -> list:
    """The ``n`` operations with the most host (self CPU) ms in one call of
    ``fn``, from torch.profiler: [name, ms, calls]."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return [[e.key, e.self_cpu_time_total / 1e3, e.count] for e in rows[:n]]


def dist_worker(seed: int, workdir: Path) -> None:
    """Items 8.3 and 8.4, in the one rank of a group that
    ``torch.distributed.run`` starts: the sharded top-k against the plain
    one, and a train step with the mesh against one without it (the same
    bits, the collectives it makes, the ms of each); prints one
    ``{"dist_worker": ...}`` line."""
    import torch.distributed as dist

    check(pdist.maybe_init_distributed(cpu=False), "no process group in the environment")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = pmesh.make_mesh()
        device = torch.device("cuda", torch.cuda.current_device())
        res = dict(backend=dist.get_backend(), world=mesh.world)

        g = torch.Generator(device=device).manual_seed(seed)
        book = torch.randn((TOPK_BOOK, 128), generator=g, device=device)
        xq = book[:TOPK_QUERIES] + 0.5 * torch.randn((TOPK_QUERIES, 128), generator=g,
                                                     device=device)
        shard = shard_codebook(mesh, book)
        ids, d = sharded_coarse_topk(mesh, xq, shard, TOPK_K, exact=False)
        want_ids, want_d = sqdist_topk(xq, book, TOPK_K)
        check(torch.equal(ids, want_ids), "sharded top-k: ids differ from sqdist_topk's")
        res.update(topk_book=TOPK_BOOK, topk_queries=TOPK_QUERIES, topk_k=TOPK_K,
                   topk_ids_equal=True, topk_max_abs_err=float((d - want_d).abs().max()))
        del ids, d, want_ids, want_d
        res["topk_ms"] = time_ms(lambda: sharded_coarse_topk(mesh, xq, shard, TOPK_K,
                                                             exact=False), reps=5, warmup=1)
        res["topk_plain_ms"] = time_ms(lambda: sqdist_topk(xq, book, TOPK_K), reps=5, warmup=1)
        del book, shard
        torch.cuda.empty_cache()

        spec = spec_of("qinco2-S")
        trained = load_checkpoint(workdir / "model.npz", spec, device=device)["params"]
        cfg = load_config(["model_args=qinco2-S"])
        xb = torch.from_numpy(np.load(workdir / "train.npy")[:TRAIN_BATCH]).to(device)
        wb = torch.ones((TRAIN_BATCH,), device=device)

        def fresh_step(m):
            p = _clone(trained)
            opt = tts.build_optimizer(cfg, p, spec)
            step = tts.make_train_step(spec, opt, cfg.grad_clip, mesh=m)
            mstate = init_model_state(spec, device=device)
            return p, lambda: step(p, mstate, xb, wb)

        (pa, step_a), (pb, step_b) = fresh_step(None), fresh_step(mesh)
        _, ma, oa = step_a()
        for k in pmesh.COLLECTIVES:
            pmesh.COLLECTIVES[k] = 0
        _, mb, ob = step_b()
        torch.cuda.synchronize()
        coll = dict(pmesh.COLLECTIVES)
        same = all(torch.equal(a, b) for a, b in zip(param_leaves(pa), param_leaves(pb)))
        same &= all(torch.equal(a, b) for a, b in zip(ma, mb))
        same &= torch.equal(oa.total_loss, ob.total_loss) and torch.equal(oa.codes, ob.codes)
        check(same, "a train step with the one-rank mesh differs from the plain step")
        # two for each MLP step's residual statistics and two for the x0
        # statistics, then two a step (train/train_step.py)
        want = 2 * spec.n_mlp_steps + 4
        check(coll["calls"] == want, f"train step: {coll['calls']} collectives, expected {want}")
        # turns: plain, group, group, plain, three times over; each turn the
        # median of 10 steps, each figure the median of its 6 turns; the
        # difference also as the median of the 6 side-by-side pairs of turns
        order = (step_a, step_b, step_b, step_a) * 3
        turns = [time_ms(fn, reps=10) for fn in order]
        by = {k: statistics.median(t for f, t in zip(order, turns) if f is fn)
              for k, fn in (("plain", step_a), ("group", step_b))}
        pairs = [turns[i + 1] - turns[i] if order[i] is step_a else turns[i] - turns[i + 1]
                 for i in range(0, len(turns), 2)]
        res.update(step_bit_identical=True, step_collectives=coll["calls"],
                   step_collective_bytes=coll["bytes"], step_ms_plain=by["plain"],
                   step_ms_group=by["group"], step_ms_group_minus_plain_pairs=pairs,
                   step_ms_group_minus_plain=statistics.median(pairs), step_ms_turns=turns,
                   step_host_top_plain=host_top(step_a), step_host_top_group=host_top(step_b))
        # one all_reduce_sum of a statistics-sized and of a step-sized buffer:
        # host ms a call (100 calls, one sync) and device ms (CUDA events)
        for label, n in (("stats", spec.D + 1), ("step", coll["bytes"] // 4)):
            buf = torch.ones((n,), device=device)
            pmesh.all_reduce_sum(mesh, [buf])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                pmesh.all_reduce_sum(mesh, [buf])
            torch.cuda.synchronize()
            res[f"allreduce_{label}_host_ms"] = (time.perf_counter() - t0) * 10
            res[f"allreduce_{label}_ms"] = time_ms(lambda: pmesh.all_reduce_sum(mesh, [buf]))
        print(json.dumps({"dist_worker": res}), flush=True)
    finally:
        pdist.shutdown()


def kmeans_pass(seed: int, device) -> dict:
    """One assignment-and-accumulate pass of the IVF k-means at the
    production book size (``KMEANS_PASS_K`` random centroids) over
    ``KMEANS_PASS_ROWS`` random rows, the port's ``accumulate_pass``: its
    seconds (host clock, synchronized), f32 TFLOP/s, bound, and the time it
    projects for the reference's k-means (``KMEANS_REF_ROWS`` rows,
    ``KMEANS_REF_ITERS`` iterations)."""
    K, n, D, chunk = KMEANS_PASS_K, KMEANS_PASS_ROWS, 128, 65536
    g = torch.Generator(device=device).manual_seed(seed + 11)
    x = torch.randn((n, D), generator=g, device=device)
    cent = torch.randn((K, D), generator=g, device=device)
    rows = DIST_BUDGET_ELEMS // chunk

    def one_pass(xr):
        sums = torch.zeros((K, D), device=device)
        counts = torch.zeros((K,), dtype=torch.int64, device=device)
        accumulate_pass(xr, cent, sums, counts, chunk=chunk, rows=rows)
        return counts

    one_pass(x[:rows])  # warm-up: one step of the pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = one_pass(x)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    check(int(counts.sum()) == n, "k-means pass: counts do not add up to the rows")
    flops = 2.0 * n * K * D
    b_ms, b_by = bound_ms(flops, 4.0 * (n * D + K * D + K * D + K), "float32")
    iter_s = sec * KMEANS_REF_ROWS / n
    return dict(ivf_K=K, rows=n, s=sec, gflop=flops / 1e9, tflops=flops / sec / 1e12,
                bound_s=b_ms / 1e3, bound_by=b_by, projected_iter_s=iter_s,
                projected_rows=KMEANS_REF_ROWS, projected_iters=KMEANS_REF_ITERS,
                projected_card_hours=iter_s * KMEANS_REF_ITERS / 3600)


def brute_force_nn(queries: np.ndarray, db: np.ndarray, device, block: int = 1000):
    """Each query's nearest DB row by brute force on the card in f32,
    ``(nq, 1)`` int32."""
    xb = torch.from_numpy(db).to(device)
    nb = (xb * xb).sum(-1)
    out = []
    for i in range(0, len(queries), block):
        q = torch.from_numpy(queries[i:i + block]).to(device)
        out.append(torch.argmin(nb - 2.0 * (q @ xb.T), dim=1).int().cpu())
    return torch.cat(out).numpy()[:, None]


def search_phase(seed: int, device, workdir: Path) -> dict:
    """The search phase (item 6 of the docstring); returns its JSON record
    with the encode runs' kernel launches."""
    t_phase = time.perf_counter()
    res = dict(kmeans_pass=kmeans_pass(seed, device))
    emit({"kmeans_pass": res["kmeans_pass"]})
    spec = spec_of("qinco2-S", f"ivf_K={SEARCH_IVF_K}", "ivf_in_use=true")
    f = {k: workdir / k for k in (
        "kmeans_train.npy", "ivf.npy", "model.npz", "train.npy", "db.npy", "queries.npy",
        "gt.npy", "codes_train.npz", "codes_db.npz", "index.qivf", "pairwise.npz",
        "results.json")}
    n_train = SEARCH_TRAIN + SEARCH_VAL

    # 1. IVF centroids, from decodes of a random model with a random IVF book
    np.save(f["kmeans_train.npy"], synthetic_data(
        spec, random_model(spec, seed + 20, device), n_train, seed + 21, NOISE))
    t0 = time.perf_counter()
    run_main(["task=ivf_centroids", f"trainset={f['kmeans_train.npy']}",
              f"output={f['ivf.npy']}", f"ivf_K={SEARCH_IVF_K}", f"ds.valset={SEARCH_VAL}",
              f"kmeans_iters={SEARCH_KMEANS_ITERS}", f"seed={seed}", "verbose=false"])
    res["ivf_centroids_s"] = time.perf_counter() - t0
    cent = np.load(f["ivf.npy"])
    check(cent.shape == (SEARCH_IVF_K, spec.D) and np.isfinite(cent).all(),
          f"ivf_centroids: centroids {cent.shape}")

    # 2. a random qinco2-S model on the trained centroids, its data
    params = random_model(spec, seed, device)
    params = params._replace(codebook0=(torch.from_numpy(cent).to(device) - params.data_mean)
                             / params.data_std)
    cfg = load_config(["model_args=qinco2-S", f"ivf_K={SEARCH_IVF_K}", "ivf_in_use=true"])
    save_checkpoint(f["model.npz"], params=params, model_state=init_model_state(spec, device=device),
                    hyperparams={k: cfg.get(k) for k in SAVED_PARAMETERS if cfg.get(k) is not None},
                    data_dim=spec.D)
    np.save(f["train.npy"], synthetic_data(spec, params, n_train, seed + 22, NOISE))
    db = synthetic_data(spec, params, SEARCH_DB, seed + 23, NOISE)
    np.save(f["db.npy"], db)
    rng = np.random.default_rng(seed + 24)
    queries = (db[:SEARCH_QUERIES] + QUERY_NOISE * rng.standard_normal(
        (SEARCH_QUERIES, spec.D))).astype(np.float32)
    gt = brute_force_nn(queries, db, device)
    np.save(f["queries.npy"], queries)
    np.save(f["gt.npy"], gt)
    res["gt_is_source_row"] = float((gt[:, 0] == np.arange(SEARCH_QUERIES)).mean())

    # 3. encode the training set and the DB through the kernels (parity)
    common = [f"model={f['model.npz']}", f"ivf_centroids={f['ivf.npy']}",
              "encode_profile=parity", "batch=1024", "verbose=false"]
    res["encode"] = {}
    for label, n, args in (
            ("trainset", n_train, [f"trainset={f['train.npy']}", "encode_trainset=true",
                                   f"ds.valset={SEARCH_VAL}", f"output={f['codes_train.npz']}"]),
            ("db", SEARCH_DB, [f"db={f['db.npy']}", f"output={f['codes_db.npz']}"])):
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        run_main(["task=encode", *args, *common])
        sec = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        per = -(-n // 1024) * spec.n_mlp_steps
        want = {k: per if k in ("selected_scores", "select_rebuild") else 0 for k in launches}
        want.update(ivf_launches(spec, -(-n // 1024), 1024, device))
        check(launches == want, f"encode {label}: launches {launches}, expected {want}")
        res["encode"][label] = dict(n=n, s=sec, vec_s=n / sec, launches=launches)
    part = np.load(f["codes_db.npz"].with_name("codes_db.part_0.npz"))["codes"]
    check(part.shape == (SEARCH_DB, spec.M_ivf), f"encode db: part file codes {part.shape}")
    trained = load_checkpoint(f["model.npz"], spec, device=device)["params"]
    first = encode_chunked(trained, spec, db[:1024], batch=1024)
    check(np.array_equal(part[:1024].T, first),
          "encode db: the part file's first chunk differs from encode_chunked's")

    # 4. the index
    t0 = time.perf_counter()
    log = run_main(["task=build_index", f"trainset={f['train.npy']}",
                    f"ivf_centroids={f['ivf.npy']}", f"encoded_trainset={f['codes_train.npz']}",
                    f"encoded_db={f['codes_db.npz']}", f"output={f['index.qivf']}",
                    f"ds.valset={SEARCH_VAL}", "verbose=false"])
    res["build_index_s"] = time.perf_counter() - t0
    res["aq_train_mse"] = float(_found(r"AQ train MSE: (\S+)", log)[0])
    res["ntotal"] = int(_found(r"ntotal=(\d+)", log)[-1])
    check(math.isfinite(res["aq_train_mse"]), f"build_index: AQ MSE {res['aq_train_mse']}")
    check(res["ntotal"] == SEARCH_DB, f"build_index: ntotal {res['ntotal']}")

    # 5. the pairwise decoder
    t0 = time.perf_counter()
    log = run_main(["task=train_pairwise_decoder", f"trainset={f['train.npy']}",
                    f"ivf_centroids={f['ivf.npy']}", f"encoded_trainset={f['codes_train.npz']}",
                    f"output={f['pairwise.npz']}", f"ds.valset={SEARCH_VAL}", f"seed={seed}",
                    "verbose=false"])
    res["train_pairwise_decoder_s"] = time.perf_counter() - t0
    res["pairwise_mse"] = [float(v) for v in _found(
        r"pairwise decoder train_MSE=(\S+) val_MSE=(\S+)", log)[0]]
    check(all(math.isfinite(v) for v in res["pairwise_mse"]),
          f"pairwise decoder: MSE {res['pairwise_mse']}")
    # where one of its 16 x 78 pair fits spends its time, at its shapes
    codes_t = np.load(f["codes_train.npz"].with_name("codes_train.part_0.npz"))["codes"]
    codes_t = torch.from_numpy(codes_t[:SEARCH_TRAIN]).to(device).long()
    resid = torch.from_numpy(np.load(f["train.npy"])[:SEARCH_TRAIN]).to(device) - torch.from_numpy(
        cent).to(device)[codes_t[:, 0]]
    K2 = spec.K * spec.K
    comb = codes_t[:, 1] * spec.K + codes_t[:, 2]
    pair_error(comb, resid, K2, min(EVAL_ROWS, SEARCH_TRAIN), 8.0)
    res["pair_fit_breakdown"] = device_breakdown(
        lambda: float(pair_error(comb, resid, K2, min(EVAL_ROWS, SEARCH_TRAIN), 8.0)))
    del codes_t, resid, comb

    # 6. the search over the grid
    t0 = time.perf_counter()
    run_main(["task=search", f"model={f['model.npz']}", f"ivf_centroids={f['ivf.npy']}",
              f"index={f['index.qivf']}", f"pairwise_decoder={f['pairwise.npz']}",
              f"queries={f['queries.npy']}", f"queries_gt={f['gt.npy']}",
              f"output={f['results.json']}", "search.nprobe=[16,64]", "search.nshort=[100]",
              "search.nmid_short=[0,4]", "search.quantizer_efSearch=[]",
              "search.explore_all=true", "search.nthreads=0", "encode_profile=parity",
              "batch=1024", "verbose=false"])
    res["search_s"] = time.perf_counter() - t0
    points = json.loads(f["results.json"].read_text())["ivf_real_res"]
    check(len(points) == 4, f"search: {len(points)} operating points, expected 4")
    res["points"] = [dict(**r["parameters"], **{f"R@{k}": v for k, v in r["recalls"].items()},
                          **{f"ms_per_query_{t}": r[f"t_{t}"] * 1e3 / SEARCH_QUERIES
                             for t in ("search", "mid_rerank", "decode", "rerank", "total")})
                     for r in points]
    r100 = [p["R@100"] for p in res["points"] if p["nprobe"] == 64]
    check(min(r100) >= 0.95, f"search: R@100 at nprobe=64 is {r100} < 0.95")
    # the device's share of one search task at one point (nprobe 64, nmid 4):
    # index and model load, the warm-up pass and the measured pass
    res["search_point_breakdown"] = device_breakdown(lambda: run_main([
        "task=search", f"model={f['model.npz']}", f"ivf_centroids={f['ivf.npy']}",
        f"index={f['index.qivf']}", f"pairwise_decoder={f['pairwise.npz']}",
        f"queries={f['queries.npy']}", f"queries_gt={f['gt.npy']}", "search.nprobe=[64]",
        "search.nshort=[100]", "search.nmid_short=[4]", "search.quantizer_efSearch=[]",
        "search.nthreads=0", "encode_profile=parity", "batch=1024", "verbose=false"]))
    res["phase_s"] = time.perf_counter() - t_phase
    emit({"search": res})
    return res


def scale_phase(workdir: Path) -> dict:
    """The scale phase (item 9 of the docstring); returns its JSON record
    with its kernel launches."""
    tsr = load_script("torch_scale_regression")
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        report = tsr.main(["--out", str(workdir), *SCALE_ARGS])
    sec = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    record = json.loads(SCALE_RECORD.read_text())
    missing = sorted(set(record) - set(report))
    check(not missing, f"scale: the report lacks the JAX report's keys {missing}")
    missing = sorted(set(record["phases"]) - set(report["phases"]))
    check(not missing, f"scale: phases {missing} did not run")
    expected = report["expected_launches"]
    check(sorted(expected) == ["encode_db", "encode_trainset", "train"],
          f"scale: launch counts checked for {sorted(expected)}")
    for name, want in expected.items():
        check(beam_launches(report["launches"][name]) == want,
              f"scale {name}: launches {report['launches'][name]}, expected {want}")
    # the IVF step's kernels also run outside the phases (the k-means sample's MSE)
    beam = beam_launches(launches)
    phase_sum = {k: sum(run.get(k, 0) for run in report["launches"].values()) for k in beam}
    check(phase_sum == beam, f"scale: launches {beam} outside the phases {phase_sum}")
    points = [dict(**p["parameters"], **{k: p[k] for k in ("R@1", "R@10", "R@100", "t_total")})
              for p in report["operating_points"]]
    r1 = [p["R@1"] for p in points if p["nprobe"] == 64 and p["nshort"] == 100]
    check(r1 and max(r1) >= SCALE_MIN_R1,
          f"scale: R@1 at nprobe 64, nshort 100 is {r1}, expected >= {SCALE_MIN_R1}")
    res = dict(args=SCALE_ARGS, s=sec, phases=report["phases"], points=points,
               launches=report["launches"], peak_device_bytes=report["peak_device_bytes"],
               **{k: report[k] for k in ("kmeans_sample_mse", "encode_db_vecs_per_s",
                                         "hnsw_vs_exact_coarse_recall@16",
                                         "int8_norm_rel_err", "pareto_prior")})
    emit({"scale": res})
    return dict(res, launches=launches)


def reference_state(params: QincoParams, spec, mstate=None) -> dict:
    """``params`` as a reference ``.pt`` state dict, the layout that
    ``task=convert`` reads: torch Linear weights are (out, in), so the
    port's (in, out) matrices are transposed; with ``mstate``, the EMA
    buffers ``xtarget_mean`` / ``xtarget_var`` too."""
    cpu = lambda a: a.detach().cpu().contiguous()
    st = params.steps
    step0 = "ivf_centroids" if spec.ivf_in_use else "codebook"
    sd = {f"steps.0.{step0}.weight": cpu(params.codebook0)}
    for i in range(spec.n_mlp_steps):
        m = f"steps.{i + 1}."
        sd[m + "codebook.weight"] = cpu(st.codebook[i])
        if st.sub_codebook is not None:
            sd[m + "substep.codebook.weight"] = cpu(st.sub_codebook[i])
        sd[m + "concat.mlp.weight"] = cpu(st.concat_w[i].T)
        sd[m + "concat.mlp.bias"] = cpu(st.concat_b[i])
        for l in range(spec.L):
            sd[m + f"residual_blocks.{l}.up_proj.weight"] = cpu(st.ffn_up[i, l].T)
            sd[m + f"residual_blocks.{l}.down_proj.weight"] = cpu(st.ffn_down[i, l].T)
        if st.in_proj is not None:
            sd[m + "in_proj.weight"] = cpu(st.in_proj[i].T)
            sd[m + "out_proj.weight"] = cpu(st.out_proj[i].T)
        if mstate is not None:
            sd[m + "xtarget_mean"] = cpu(mstate.xtarget_mean[i])
            sd[m + "xtarget_var"] = cpu(mstate.xtarget_var[i])
    sd["data_mean"], sd["data_std"] = cpu(params.data_mean), cpu(params.data_std)
    return sd


class LaunchTally:
    """Kernel launches summed over the legacy phase's task runs."""

    def __init__(self):
        self.total = {k: 0 for k in kernels.LAUNCHES}

    def run(self, argv) -> tuple[str, float, dict]:
        """``run_main(argv)`` with the counts set to 0 just before it:
        (log, seconds, this run's launches)."""
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        log = run_main(argv)
        sec = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        for k, v in launches.items():
            self.total[k] += v
        return log, sec, launches


def expect_encode_launches(label, launches, rows, spec) -> None:
    """Exact counts of parity encodes of ``rows`` (a count for each
    encode) at batch 1024: B2 and B3 once per MLP step and chunk, no other
    beam-step kernel (the IVF step's are checked on the paths, ``run_path``)."""
    per = sum(-(-n // 1024) for n in rows) * spec.n_mlp_steps
    launches = beam_launches(launches)
    want = {k: per if k in ("selected_scores", "select_rebuild") else 0 for k in launches}
    check(launches == want, f"{label}: launches {launches}, expected {want}")


def legacy_convert(spec, device, workdir: Path, train_dir: Path, tally: LaunchTally) -> dict:
    """Item 7's convert checks."""
    ck = load_checkpoint(train_dir / "model.npz", spec, device=device)
    meta = ck["meta"]
    pt = workdir / "qinco2_S.pt"
    torch.save({"epoch": meta["epoch"], "model": reference_state(ck["params"], spec, ck["mstate"]),
                "parameters": meta["parameters"], "data_dim": meta["data_dim"]}, pt)
    conv = workdir / "converted.npz"
    _, convert_s, _ = tally.run(["task=convert", f"model={pt}", f"output={conv}", "verbose=false"])
    back = load_checkpoint(conv, spec, device=device)
    leaves = param_leaves(ck["params"]) + [ck["mstate"].xtarget_mean, ck["mstate"].xtarget_var]
    got = param_leaves(back["params"]) + [back["mstate"].xtarget_mean, back["mstate"].xtarget_var]
    check(len(got) == len(leaves) and all(torch.equal(a, b) for a, b in zip(got, leaves)),
          "convert: the converted checkpoint differs from the original")
    check(back["meta"]["parameters"] == meta["parameters"], "convert: parameters differ")

    codes = {}
    for name, model in (("original", train_dir / "model.npz"), ("converted", conv)):
        out = workdir / f"codes_{name}.npy"
        _, _, launches = tally.run(["task=encode_codec", f"model={model}",
                                    f"db={train_dir / 'val.npy'}", f"output={out}",
                                    "encode_profile=parity", "batch=1024", "verbose=false"])
        expect_encode_launches(f"encode_codec ({name})", launches, [TRAIN_VAL], spec)
        codes[name] = np.load(out)
    check(np.array_equal(codes["original"], codes["converted"]),
          "convert: the converted checkpoint encodes to other codes")

    # a QINCo1-era file at bigann widths (the qinco1 preset, D = 128):
    # random weights in the v1 module layout, no norms, a stray step-0
    # substep codebook
    v1 = spec_of("qinco1", profile=None)
    g = torch.Generator().manual_seed(7)
    rnd = lambda *shape: 0.1 * torch.randn(shape, generator=g)
    sd = {"steps.0.codebook.weight": rnd(v1.K, v1.D), "steps.0.substep.codebook.weight":
          rnd(v1.K, v1.D)}
    for m in range(1, v1.M):
        sd[f"steps.{m}.codebook.weight"] = rnd(v1.K, v1.D)
        sd[f"steps.{m}.concat.mlp.weight"] = rnd(v1.De, v1.De + v1.D)
        sd[f"steps.{m}.concat.mlp.bias"] = rnd(v1.De)
        for l in range(v1.L):
            sd[f"steps.{m}.residual_blocks.{l}.up_proj.weight"] = rnd(v1.dh, v1.De)
            sd[f"steps.{m}.residual_blocks.{l}.down_proj.weight"] = rnd(v1.De, v1.dh)
    hp = dict(K=v1.K, M=v1.M, de=v1.de, dh=v1.dh, L=v1.L, A=0, B=1, ivf_in_use=False,
              qinco1_mode=True)
    torch.save({"epoch": 60, "model": sd, "parameters": hp}, workdir / "v1.pt")
    tally.run(["task=convert", f"model={workdir / 'v1.pt'}", f"output={workdir / 'v1.npz'}",
               "db=bigann1B", "verbose=false"])
    v1_params = load_checkpoint(workdir / "v1.npz", v1, device=device)["params"]
    with np.load(Path(__file__).parent / "qinco_torch/assets/v1_dataset_norms.npz") as z:
        mean, std = z["bigann1M__mean"], float(z["bigann1M__std"])
    check(np.array_equal(v1_params.data_mean.cpu().numpy(), mean)
          and float(v1_params.data_std) == np.float32(std),
          "convert v1: the data norms are not bigann1M's")
    v1_codes = torch.randint(0, v1.K, (v1.M, 1024), generator=g).to(device)
    check(bool(torch.isfinite(decode_raw(v1_params, v1, v1_codes)).all()),
          "convert v1: decode is not finite")
    return dict(convert_s=convert_s, leaves=len(leaves), leaves_equal=True,
                encode_rows=TRAIN_VAL, codes_equal=True, v1_norms="bigann1M", v1_L=v1.L)


def legacy_codec(spec, device, workdir: Path, model: Path, data: np.ndarray,
                 tally: LaunchTally) -> dict:
    """Item 7's encode_codec / decode_codec checks."""
    n = len(data)
    np.save(workdir / "codec_db.npy", data)
    common = [f"model={model}", "encode_profile=parity", "batch=1024", "verbose=false"]
    res, decoded, launches = {}, {}, {}
    for ext in ("npy", "qcod"):
        codes_file = workdir / f"codec_codes.{ext}"
        _, sec, launches[ext] = tally.run(["task=encode_codec", f"db={workdir / 'codec_db.npy'}",
                                           f"output={codes_file}", *common])
        expect_encode_launches(f"encode_codec .{ext}", launches[ext], [n], spec)
        res[f"encode_{ext}_vec_s"] = n / sec
        _, sec, _ = tally.run(["task=decode_codec", f"encoded_db={codes_file}",
                               f"output={workdir / f'codec_decoded_{ext}.npy'}", *common])
        res[f"decode_{ext}_vec_s"] = n / sec
        decoded[ext] = np.load(workdir / f"codec_decoded_{ext}.npy")
    packed_bytes = (workdir / "codec_codes.qcod").stat().st_size - 20
    check(packed_bytes == 8 * n, f"packed codes: {packed_bytes} bytes for {n} vectors")
    check(np.array_equal(decoded["npy"], decoded["qcod"]),
          "decode_codec: the .npy and the packed codes decode differently")
    params = load_checkpoint(model, spec, device=device)["params"]
    codes = torch.from_numpy(np.load(workdir / "codec_codes.npy").T.copy()).to(device)
    want = torch.cat([decode_raw(params, spec, codes[:, i:i + 1024])
                      for i in range(0, n, 1024)]).cpu().numpy()
    check(np.array_equal(decoded["npy"], want), "decode_codec differs from decode_raw")
    rel = float(((decoded["npy"] - data) ** 2).sum(-1).mean() / (data ** 2).sum(-1).mean())
    return dict(rows=n, bytes_per_vector=packed_bytes / n, relative_mse=rel,
                launches_per_encode=launches["npy"], **res)


def legacy_two_stage(spec, device, workdir: Path, model: Path, source: QincoParams,
                     seed: int, tally: LaunchTally) -> dict:
    """Item 7's search_2stage run."""
    f = {k: workdir / f"two_stage_{k}.npy" for k in ("train", "db", "queries", "gt")}
    np.save(f["train"], synthetic_data(spec, source, TWO_STAGE_TRAIN + TWO_STAGE_VAL, seed + 31,
                                       NOISE))
    db = synthetic_data(spec, source, TWO_STAGE_DB, seed + 32, NOISE)
    rng = np.random.default_rng(seed + 33)
    queries = (db[:TWO_STAGE_QUERIES] + QUERY_NOISE * rng.standard_normal(
        (TWO_STAGE_QUERIES, spec.D))).astype(np.float32)
    np.save(f["db"], db)
    np.save(f["queries"], queries)
    np.save(f["gt"], brute_force_nn(queries, db, device))
    del db
    out = workdir / "two_stage.json"
    log, sec, launches = tally.run([
        "task=search_2stage", f"model={model}", f"trainset={f['train']}", f"db={f['db']}",
        f"queries={f['queries']}", f"queries_gt={f['gt']}", f"output={out}",
        f"ds.valset={TWO_STAGE_VAL}", f"search.nshort={list(TWO_STAGE_NSHORT)}",
        "encode_profile=parity", "batch=1024", "verbose=false"])
    # the AQ fit's encode of the training rows, then the DB's
    expect_encode_launches("search_2stage", launches, [TWO_STAGE_TRAIN, TWO_STAGE_DB], spec)
    results = json.loads(out.read_text())
    timers = re.findall(r"T_shortlist=(\S+)s T_rerank=(\S+)s", log)
    check(len(timers) == len(TWO_STAGE_NSHORT) and sorted(map(int, results)) == list(
        TWO_STAGE_NSHORT), f"search_2stage: results for {sorted(results)}")
    points = []
    for nshort, (t_short, t_rerank) in zip(TWO_STAGE_NSHORT, timers):
        r = results[str(nshort)]
        points.append(dict(nshort=nshort, **{f"R@{k}": v for k, v in r.items()},
                           ms_per_query_shortlist=float(t_short) * 1e3 / TWO_STAGE_QUERIES,
                           ms_per_query_rerank=float(t_rerank) * 1e3 / TWO_STAGE_QUERIES))
        check(r["100"] >= 0.95, f"search_2stage: R@100 {r['100']} < 0.95 at nshort={nshort}")
    # where one query batch's time goes: the shortlist of 256 queries over
    # the DB's codes (random codes and books of the same shapes), and one
    # rerank decode of decode_batch (search.batch_size) candidates
    from qinco_torch.search.two_stage import _aq_shortlist

    g = torch.Generator(device=device).manual_seed(seed + 34)
    codes = torch.randint(0, spec.K, (spec.M, TWO_STAGE_DB), generator=g, device=device)
    books = torch.randn((spec.M, spec.K, spec.D), generator=g, device=device)
    norms = torch.rand((TWO_STAGE_DB,), generator=g, device=device)
    q = torch.from_numpy(queries[:256]).to(device)
    params = load_checkpoint(model, spec, device=device)["params"]
    decode_batch = load_config([]).search.batch_size
    shortlist = {nshort: device_breakdown(lambda: _aq_shortlist(q, codes, books, norms, nshort))
                 for nshort in TWO_STAGE_NSHORT}
    rerank_decode = device_breakdown(lambda: decode_raw(params, spec, codes[:, :decode_batch]))
    return dict(train_rows=TWO_STAGE_TRAIN, db=TWO_STAGE_DB, queries=TWO_STAGE_QUERIES, s=sec,
                launches=launches, points=points, shortlist_batch_breakdown=shortlist,
                rerank_decode_batch=decode_batch, rerank_decode_breakdown=rerank_decode)


def pq_data(n: int, seed: int, rows_seed: int, device) -> np.ndarray:
    """``n`` rows of D = 256 synthetic embeddings: Gaussian with a decaying
    spectrum (std exp(-i/64) along the i-th of random orthogonal axes
    drawn from ``seed``), so the dimensions correlate and a rotation
    matters to the product split; the rows are drawn from ``rows_seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    axes, _ = torch.linalg.qr(torch.randn((PQ_D, PQ_D), generator=g, device=device))
    scale = torch.exp(-torch.arange(PQ_D, device=device) / 64.0)
    g.manual_seed(rows_seed)
    z = torch.randn((n, PQ_D), generator=g, device=device)
    return ((z * scale) @ axes.T).cpu().numpy()


def legacy_pq(device, workdir: Path, seed: int, tally: LaunchTally) -> dict:
    """Item 7's train_pq / eval_pq runs."""
    f = {k: workdir / f"pq_{k}.npy" for k in ("train", "db", "queries", "gt")}
    np.save(f["train"], pq_data(PQ_TRAIN + PQ_VAL, seed + 40, seed + 41, device))
    db = pq_data(PQ_DB, seed + 40, seed + 42, device)
    rng = np.random.default_rng(seed + 43)
    queries = (db[:PQ_QUERIES] + QUERY_NOISE * rng.standard_normal((PQ_QUERIES, PQ_D))).astype(
        np.float32)
    np.save(f["db"], db)
    np.save(f["queries"], queries)
    np.save(f["gt"], brute_force_nn(queries, db, device))
    model = workdir / "pq.pqnpz"
    torch.cuda.reset_peak_memory_stats()
    log, train_s, launches = tally.run([
        "task=train_pq", f"trainset={f['train']}", f"output={model}", *PQ_ARGS,
        f"ds.valset={PQ_VAL}", "epochs=1", "scheduler.stop_patience=0", f"seed={seed}",
        "batch=1024", "verbose=false"])
    opq_s = float(_found(r"OPQ rotation trained \((\S+)s\)", log)[0])
    part_s = [float(v) for v in _found(r"PQ part \d+/\d+ trained \((\S+)s\)", log)]
    epochs = len(_found(r"Start epoch \d+ ", log)) // 2
    val_mse = float(_found(r"PQ-QINCo validation MSE: (\S+)", log)[0])
    # the closing report encodes 10,000 rows in one call
    train_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log, eval_s, eval_launches = tally.run([
        "task=eval_pq", f"db={f['db']}", f"model={model}", f"queries={f['queries']}",
        f"queries_gt={f['gt']}", "batch=1024", "verbose=false"])
    db_mse = float(_found(r"PQ-QINCo DB MSE: (\S+)", log)[0])
    enc_s = float(_found(r"Encoded \d+ vectors \((\S+)s\)", log)[0])
    recalls = [float(v) / 100 for v in _found(r"R@1=(\S+) R@10=(\S+) R@100=(\S+)", log)[0]]
    check(not any(beam_launches(launches).values())
          and not any(beam_launches(eval_launches).values()),
          "PQ: the exact profile launched a beam-step kernel")
    energy = float((db.astype(np.float64) ** 2).sum(-1).mean())
    # below the data's energy: better than the mean (zero) for every row
    check(len(part_s) == 2 and 0 < db_mse < energy and 0 < val_mse < energy,
          f"PQ: MSE {val_mse} / {db_mse} against an energy of {energy}")

    # the model's encode on the card against the CPU's, on a few DB rows
    from qinco_torch.models.pq_qinco import pq_encode
    from qinco_torch.tasks.pq_task import load_pq_checkpoint

    x = torch.from_numpy(db[:64])
    outs = []
    for dev in (device, torch.device("cpu")):
        params, sub_spec, n_parts = load_pq_checkpoint(model, device=dev)
        outs.append(pq_encode(params, sub_spec, n_parts, x.to(dev)))
    agree = (outs[0][0].cpu() == outs[1][0]).float().mean().item()
    xhat_err = (outs[0][1].cpu() - outs[1][1]).abs().max().item()
    check(agree >= 0.99 and xhat_err <= 1e-3,
          f"PQ encode on the card vs the CPU: codes agree {agree}, xhat max |diff| {xhat_err}")
    params, sub_spec, n_parts = load_pq_checkpoint(model, device=device)
    chunk = torch.from_numpy(db[:1024]).to(device)
    breakdown = device_breakdown(lambda: pq_encode(params, sub_spec, n_parts, chunk))
    return dict(D=PQ_D, args=PQ_ARGS, train_rows=PQ_TRAIN, val_rows=PQ_VAL, db=PQ_DB,
                queries=PQ_QUERIES, epochs_run=epochs, train_pq_s=train_s, opq_s=opq_s,
                part_train_s=part_s, eval_pq_s=eval_s, encode_s=enc_s,
                encode_vec_s=PQ_DB / enc_s, val_mse=val_mse, db_mse=db_mse, db_energy=energy,
                **dict(zip(("R@1", "R@10", "R@100"), recalls)),
                card_vs_cpu_code_agreement=agree, card_vs_cpu_xhat_max_abs=xhat_err,
                train_pq_peak_gib=train_peak_gib, encode_chunk_breakdown=breakdown)


def legacy_phase(seed: int, device, workdir: Path, train_dir: Path) -> dict:
    """The legacy phase (item 7 of the docstring); returns its JSON record
    with the phase's kernel launches."""
    t_phase = time.perf_counter()
    spec = spec_of("qinco2-S")
    model = train_dir / "model.npz"
    tally = LaunchTally()
    res = dict(convert=legacy_convert(spec, device, workdir, train_dir, tally))
    source = random_model(spec, seed, device)  # the train phase's data distribution
    res["codec"] = legacy_codec(spec, device, workdir, model,
                                synthetic_data(spec, source, CODEC_ROWS, seed + 30, NOISE), tally)
    res["search_2stage"] = legacy_two_stage(spec, device, workdir, model, source, seed, tally)
    del source
    torch.cuda.empty_cache()
    res["pq"] = legacy_pq(device, workdir, seed, tally)
    res["launches"] = tally.total
    res["reduced"] = [
        "convert: the train phase's 32-step qinco2-S checkpoint, not a reference-trained one; "
        "the QINCo1-era file has random weights",
        f"encode_codec / decode_codec: {CODEC_ROWS} rows, not a whole DB",
        f"search_2stage: the AQ fit on {TWO_STAGE_TRAIN} rows; nshort {list(TWO_STAGE_NSHORT)} "
        "of the reference's 10..1000 sweep; synthetic data, not BigANN/Deep1M",
        f"PQ: D = {PQ_D} synthetic rows, not FB-ssnpp; {PQ_TRAIN} + {PQ_VAL} training rows, "
        "epochs=1 with stop_patience=0 (two passes), not 60 epochs over millions; "
        f"a {PQ_DB}-row DB with {PQ_QUERIES} queries, not 1M rows",
    ]
    res["phase_s"] = time.perf_counter() - t_phase
    emit({"legacy": res})
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=8192, help="vectors per encode run")
    ap.add_argument("--dist-worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    t_start = time.perf_counter()
    if args.dist_worker:
        dist_worker(args.seed, args.dist_worker)
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t = time.perf_counter()
    # the native IVF library (g++) builds beside the kernels (nvcc)
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(build_native)
        reports = kernels.build()
        native_lib = native.result()
    emit({"build_s": time.perf_counter() - t, "native_lib": str(native_lib), "ptxas": {
        name: re.findall(r"Used \d+ registers|\d+ bytes spill stores", log)
        for name, log in reports.items()}})

    N, seed = 1024, args.seed
    s, m = spec_of("qinco2-S"), spec_of("qinco2-M")
    speed_s, speed_m = spec_of("qinco2-S", profile="speed"), spec_of("qinco2-M", profile="speed")
    main_shape = {}  # kernel -> its check at its main path's shape, for the summary line

    res = check_selected("qinco2-S", s, N, s.B, s.A, seed, device)
    main_shape.update(res)
    check_selected("qinco2-S IVF first step", s, N, 1, max(s.B, s.A), seed, device)
    check_selected("qinco2-M", m, N, m.B, m.A, seed, device)
    main_shape["fused_substep_scores"] = check_fused(
        "qinco2-S speed", speed_s, N, s.B, s.A, seed, device)
    check_fused("qinco2-S speed IVF first step", speed_s, N, 1, max(s.B, s.A), seed, device)
    check_fused("qinco2-M speed", speed_m, N, m.B, m.A, seed, device)
    check_selected("qinco2-S pallas=true (f32, folded table)",
                   spec_of("qinco2-S", "pallas=true", profile=None), N, s.B, s.A, seed, device,
                   external=True)
    check_selected("qinco2-S parity fused_topa=false (bf16, lean table)",
                   spec_of("qinco2-S", "fused_topa=false"), N, s.B, s.A, seed, device,
                   external=True)
    main_shape["candidate_scores"] = check_candidate(
        "qinco2-S widths K=1024", spec_of("qinco2-S", "K=1024"), N, s.B, s.A, seed,
        device)["candidate_scores"]
    check_candidate(f"qinco2-S concat_rank={CONCAT_RANK}", s.with_(concat_rank=CONCAT_RANK),
                    N, s.B, s.A, seed, device)
    check_candidate("qinco2-M widths K=1024", spec_of("qinco2-M", "K=1024"), N, m.B, m.A, seed,
                    device)
    # the f32 routes, all on the register-tiled stage: B4 in each table
    # layout (and at the IVF first step and the qinco2-M widths), B3 at the
    # qinco2-S and -M widths, B2' and B5 at the qinco2-S and -M widths, B5
    # with a low-rank factor (and B3 with it, on its output), B2' with the
    # in-kernel top-A (and B3 on its output)
    speed_f32 = speed_s.with_(compute_dtype="float32")
    check_fused("qinco2-S speed f32", speed_f32, N, s.B, s.A, seed, device)
    check_fused("qinco2-S speed f32 fold_up=false", speed_f32.with_(fold_up=False), N, s.B, s.A,
                seed, device)
    check_fused(f"qinco2-S speed f32 concat_rank={CONCAT_RANK}",
                speed_f32.with_(concat_rank=CONCAT_RANK), N, s.B, s.A, seed, device)
    check_fused("qinco2-S speed f32 IVF first step", speed_f32, N, 1, max(s.B, s.A), seed, device)
    check_fused("qinco2-M speed f32", speed_m.with_(compute_dtype="float32"), N, m.B, m.A, seed,
                device)
    check_rebuild_alone("qinco2-S f32", s.with_(compute_dtype="float32"), N, s.B, s.A, seed,
                        device)
    check_rebuild_alone("qinco2-M f32", m.with_(compute_dtype="float32"), N, m.B, m.A, seed,
                        device)
    check_candidate("qinco2-S widths K=1024 f32",
                    spec_of("qinco2-S", "K=1024").with_(compute_dtype="float32"), N, s.B, s.A,
                    seed, device)
    check_candidate("qinco2-M widths K=1024 f32",
                    spec_of("qinco2-M", "K=1024").with_(compute_dtype="float32"), N, m.B, m.A,
                    seed, device)
    check_candidate(f"qinco2-S concat_rank={CONCAT_RANK} f32",
                    s.with_(concat_rank=CONCAT_RANK, compute_dtype="float32"), N, s.B, s.A, seed,
                    device)
    check_selected("qinco2-M pallas=true (f32, folded table)",
                   spec_of("qinco2-M", "pallas=true", profile=None), N, m.B, m.A, seed, device,
                   external=True)
    check_selected("qinco2-S fast_encode=true pallas=true (f32, in-kernel top-A)",
                   spec_of("qinco2-S", "pallas=true", "fast_encode=true", profile=None), N, s.B,
                   s.A, seed, device)
    bd = breakdown_phase(seed, device)
    deep_kernel_checks(N, seed, device)
    wide_kernel_checks(N, seed, device)
    ivf = ivf_kernel_checks(seed, device)

    # (label, spec, scoring kernel, data noise, MSE bound and least code
    # agreement vs exact)
    paths = [
        ("qinco2-S", s, "selected_scores", NOISE, 1.01, 0.9),
        ("qinco2-S IVF 2^20", spec_of("qinco2-S", "ivf_in_use=true"), "selected_scores", NOISE,
         1.01, 0.9),
        ("qinco2-S speed", speed_s, "fused_substep_scores", SPEED_NOISE, 1.05, None),
        ("qinco2-S speed IVF 2^20", spec_of("qinco2-S", "ivf_in_use=true", profile="speed"),
         "fused_substep_scores", SPEED_NOISE, 1.05, None),
        ("qinco2-S speed f32", spec_of("qinco2-S", "compute_dtype=float32", profile="speed"),
         "fused_substep_scores", SPEED_NOISE, 1.05, None),
        ("qinco2-S pallas=true", spec_of("qinco2-S", "pallas=true", profile=None),
         "selected_scores", NOISE, 1.01, 0.95),
        ("qinco2-S K=1024", spec_of("qinco2-S", "K=1024"), "candidate_scores", NOISE, 1.01,
         0.9),
        ("qinco2-S pallas=true K=1024", spec_of("qinco2-S", "pallas=true", "K=1024", profile=None),
         "candidate_scores", NOISE, 1.01, 0.95),
    ]
    launches = drive_paths(paths, args.n, N, seed, device)
    for k, v in bd["launches"].items():
        launches[k] += v
    for k, v in drive_paths(deep_paths() + wide_paths(), args.n, N, seed, device).items():
        launches[k] += v

    # the train phase's directory lives on to the legacy phase, which
    # converts and encodes with its checkpoint
    with tempfile.TemporaryDirectory(dir=kernels.build_dir()) as train_dir:
        train = train_phase(seed, device, Path(train_dir))
        for k, v in train["launches"].items():
            launches[k] += v
        with tempfile.TemporaryDirectory(dir=kernels.build_dir()) as tmp:
            deep = deep_train_phase(seed, device, Path(tmp))
        for k, v in deep["launches"].items():
            launches[k] += v
        torch.cuda.empty_cache()
        dist = dist_phase(seed, Path(train_dir), train["repeat"])
        for k, v in dist["launches"].items():
            launches[k] += v
        with tempfile.TemporaryDirectory(dir=kernels.build_dir()) as tmp:
            search = search_phase(seed, device, Path(tmp))
        for run in search["encode"].values():
            for k, v in run["launches"].items():
                launches[k] += v
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(dir=kernels.build_dir()) as tmp:
            legacy = legacy_phase(seed, device, Path(tmp), Path(train_dir))
    for k, v in legacy["launches"].items():
        launches[k] += v
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=kernels.build_dir()) as tmp:
        scale = scale_phase(Path(tmp))
    for k, v in scale["launches"].items():
        launches[k] += v

    emit({"smoke_s": time.perf_counter() - t_start})
    emit({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=replaces, launches=launches[k],
             pallas_call=f"qinco_tpu/ops/pallas_kernels.py:{PALLAS_CALLS[k]}",
             max_abs_err=main_shape[k]["max_abs_err"], ms=main_shape[k]["ms"],
             plain_ms=main_shape[k]["plain_ms"], bound_ms=main_shape[k]["bound_ms"],
             bound_by=main_shape[k]["bound_by"], library_ms=None,
             tflops=main_shape[k]["tflops"], design=main_shape[k]["design"],
             ms_batch=main_shape[k]["ms_batch"])
        for k, (src, replaces) in SOURCES.items()] + [
        dict(name=k, route="cuda", source=src, replaces=replaces, pallas_call=replaces, body=body,
             **{"library_ms": None, **bd["kernels"][k]})
        for k, (src, replaces, body) in BREAKDOWN_SOURCES.items()] + [
        dict(name=k, route="cuda", source=SOURCES["fused_substep_scores"][0], replaces=replaces,
             pallas_call=replaces, body=body, alias_of="fused_substep_scores",
             why="production B4's function through a TPU layout of its fetch; the card's B4 "
                 "gathers by id", **bd["kernels"]["b4_script"])
        for k, (replaces, body) in B4_ALIASES.items()] + [
        dict(name="nearest", route="cuda", source="qinco_torch/csrc/nearest.cu", replaces=None,
             pallas_call=None, why="the IVF step 0, which the JAX package leaves to XLA",
             launches=launches["nearest"], merges=launches["nearest_merge"],
             max_abs_err=None, library_ms=None, **{k: ivf[k] for k in (
                 "ms", "ms_batch", "plain_ms", "bound_ms", "bound_by", "tflops", "design",
                 "max_rel_err")})]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
