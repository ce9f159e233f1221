#!/usr/bin/env python
"""Phase breakdown of B2, the in-kernel exact top-A scoring kernel, on a
CUDA card: the PyTorch port's counterpart of scripts/ktopa_breakdown.py.

    python scripts/torch_ktopa_breakdown.py [--variants production,full,...]
        [--iters 20] [--row-tiles 32,16] [--n 1024] [--out ktopa.json]
        [--device cuda|cpu] [--seed 0]

Shapes and inputs are the JAX script's: qinco2-S widths (D = de = 128,
dh = 256, K = 256, L = 2, A = 16, B = 32, no in/out projection, bf16),
N = 1024 vectors (N·B = 32768 beam rows), the arrays of its make_inputs
(numpy normal x 0.1 from the seed, in its order).  Variants:

- ``production``: ``kernels.selected_scores``, B2 as the encode runs it;
- the modes of ``qinco_torch.ops.breakdown.ktopa_variant`` (``full``,
  ``noextract``, ``deferred``, ``mlponly``, ``nodist``, ``shell``,
  ``perslot``, ``catfetch``, ``tournament``: that module says what each
  cuts).  ``deferred`` and ``catfetch`` launch ``full``'s kernel on the
  card and are timed once, as ``full``.

Each runs ``--iters`` back-to-back calls after a warm-up call, timed
between two CUDA events (``ms_per_step``: each call includes its
wrapper's weight casts and, where the kernel is shorter, its host work),
then ``--iters`` more under torch.profiler (``kernel_ms``: the device ms
a launch of the kernel alone).  ``--row-tiles`` sets the beam rows of a
work item of the breakdown kernels (powers of 2 up to 32; default the
launch plan's, 32 at these shapes); a value the card does not take is
recorded as an error, as the JAX script records one.  Prints one line a
variant and writes the JAX script's JSON (``utc``, ``batch``,
``ms_per_step`` keyed ``<variant>@R<rows>``) with ``kernel_ms`` and
``device``: the card's name and power limit.  Runs on the card unless ``--device cpu`` is given
(there the plain versions, timed by the host clock).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]  # qinco_torch, torch_timing

from qinco_torch.models.params import StepParams  # noqa: E402
from qinco_torch.models.spec import QincoSpec  # noqa: E402
from qinco_torch.ops import breakdown, kernels  # noqa: E402
from qinco_torch.utils import resolve_device  # noqa: E402
from torch_timing import time_variants  # noqa: E402

SPEC = QincoSpec(D=128, K=256, M=8, L=2, de=128, dh=256, A=16, B=32, fast=True, pallas=True,
                 fused_topa=True, compute_dtype="bfloat16")
N = 1024  # vectors, as the JAX script's production bench batch
KERNEL = "selected_scores_tc_kernel"  # the kernel every variant launches once a call
DEFAULT_VARIANTS = "production,full,noextract,deferred,tournament"


def make_inputs(seed: int, n: int = N) -> dict:
    """The JAX script's inputs (its make_inputs) at ``n`` vectors, numpy."""
    rng = np.random.default_rng(seed)
    D, K, De, Dh, L = SPEC.D, SPEC.K, SPEC.De, SPEC.dh, SPEC.L

    def f(*s):
        return rng.normal(size=s).astype(np.float32) * 0.1

    return dict(x=f(n, D), xh=f(n * SPEC.B, D), sub_codebook=f(K, D), codebook=f(K, D),
                concat_w=f(De + D, De), concat_b=f(De), ffn_up=f(L, De, Dh),
                ffn_down=f(L, Dh, De))


def step_params(kw: dict, device) -> StepParams:
    t = {k: torch.from_numpy(v).to(device) for k, v in kw.items()}
    return StepParams(codebook=t["codebook"], sub_codebook=t["sub_codebook"],
                      concat_w=t["concat_w"], concat_w2=None, concat_b=t["concat_b"],
                      ffn_up=t["ffn_up"], ffn_down=t["ffn_down"], in_proj=None, out_proj=None)


def call_of(variant: str, x, xh, p, rows):
    """The call a variant times."""
    if variant == "production":
        return lambda: kernels.selected_scores(SPEC, x, xh, p, SPEC.A)
    if variant not in kernels.KTOPA_MODES:
        raise SystemExit(f"unknown variant {variant!r}")
    return lambda: breakdown.ktopa_variant(SPEC, x, xh, p, SPEC.A, variant, rows=rows)


def rows_of(variant: str, xh, p, rows):
    """The beam rows a work item of the variant's launch (None on the CPU);
    production takes its plan's whatever ``rows`` says."""
    if xh.device.type != "cuda":
        return None
    if variant == "production":
        return kernels.selected_plan(xh.shape[0], SPEC.A, SPEC.D, SPEC.K, SPEC.De, SPEC.dh,
                                     bf16=True, topa=True, stages=2 + 2 * SPEC.L,
                                     sms=kernels.sm_count(xh.device)).per_item
    return breakdown.ktopa_plan(SPEC, xh, p, SPEC.A, rows).per_item


def run(variants, iters: int = 20, row_tiles=(None,), n: int = N, device=None,
        seed: int = 0) -> dict:
    """Times each variant at each rows a work item (None: the plan's) on
    ``n`` vectors; returns the JSON the script writes."""
    device = resolve_device(device)
    kw = make_inputs(seed, n)
    x, xh = (torch.from_numpy(kw[k]).to(device) for k in ("x", "xh"))
    p = step_params(kw, device)
    return time_variants(
        list(dict.fromkeys(kernels.KTOPA_ALIASES.get(v, v) for v in variants)),
        lambda v, rows: call_of(v, x, xh, p, rows),
        lambda v, rows: rows_of(v, xh, p, rows), iters, row_tiles, device, KERNEL, n)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", type=str, default=DEFAULT_VARIANTS)
    ap.add_argument("--row-tiles", type=str, default=None,
                    help="beam rows a work item, comma-separated (default: the plan's)")
    ap.add_argument("--n", type=int, default=N, help="vectors")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    row_tiles = [int(r) for r in args.row_tiles.split(",")] if args.row_tiles else [None]
    res = run(args.variants.split(","), args.iters, row_tiles, args.n, args.device, args.seed)
    print(json.dumps(res["device"]), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
