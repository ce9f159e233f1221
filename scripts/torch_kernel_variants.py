#!/usr/bin/env python
"""Phase timings of B4, the fused-substep scoring kernel (the speed
profile), on a CUDA card: the PyTorch port's counterpart of
scripts/kernel_variants.py for its module-level kernels.

    python scripts/torch_kernel_variants.py [--variants full,sel,self]
        [--iters 10] [--row-tiles 16,32] [--n 4096] [--out variants.json]
        [--device cuda|cpu] [--seed 0]

Shapes and inputs are the JAX script's: qinco2-S widths (D = de = 128,
dh = 256, K = 256, L = 2, A = 16, B = 32, bf16) with its random in and
out projections (D x de, de x D), N = 4096 vectors (N·B = 131072 beam
rows), the arrays of its make_inputs (numpy normal x 0.1 from the seed,
in its order).  Variants:

- ``production`` and ``full``: ``kernels.fused_substep_scores``, B4 as the
  encode runs it (the JAX script's ``full`` calls its production kernel);
- ``sel`` and ``sel+fetch`` (or ``self``): the cuts of
  ``qinco_torch.ops.breakdown.fused_cut``: the binned selection alone, and
  with the fetch of each winner's row of the script's 384-wide table.

Each runs ``--iters`` back-to-back calls after a warm-up call, timed
between two CUDA events (``ms_per_step``: each call includes its
wrapper's weight casts and, where the kernel is shorter, its host work),
then ``--iters`` more under torch.profiler (``kernel_ms``: the device ms
a launch of the kernel alone).
``--row-tiles`` sets the beam rows of a work item of the cuts (powers of
2 up to 32; default the launch plan's, 16 at these shapes), not of the
production kernel, whose plan's rows the result's key names.  Prints one
line a variant and writes JSON (``utc``, ``batch``, ``ms_per_step`` keyed
``<variant>@R<rows>``, ``kernel_ms``, ``device``: the card's name and
power limit).
Runs on the card unless ``--device cpu`` is given (there the plain
versions, timed by the host clock).
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
                 fused_substep=True, compute_dtype="bfloat16")
N = 4096  # vectors, as the JAX script's
KERNEL = "fused_substep_tc_kernel"  # the kernel every variant launches once a call
DEFAULT_VARIANTS = "full,sel,self"
ALIASES = {"self": "sel+fetch"}


def make_inputs(seed: int, n: int = N) -> dict:
    """The JAX script's inputs (its make_inputs) at ``n`` vectors, numpy."""
    rng = np.random.default_rng(seed)
    D, K, De, Dh, L = SPEC.D, SPEC.K, SPEC.De, SPEC.dh, SPEC.L

    def f(*s):
        return rng.normal(size=s).astype(np.float32) * 0.1

    return dict(x=f(n, D), xh=f(n * SPEC.B, D), sub_codebook=f(K, D), codebook=f(K, D),
                in_proj=f(D, De), concat_w=f(De + D, De), concat_b=f(De), ffn_up=f(L, De, Dh),
                ffn_down=f(L, Dh, De), out_proj=f(De, D))


def step_params(kw: dict, device) -> StepParams:
    t = {k: torch.from_numpy(v).to(device) for k, v in kw.items()}
    return StepParams(codebook=t["codebook"], sub_codebook=t["sub_codebook"],
                      concat_w=t["concat_w"], concat_w2=None, concat_b=t["concat_b"],
                      ffn_up=t["ffn_up"], ffn_down=t["ffn_down"], in_proj=t["in_proj"],
                      out_proj=t["out_proj"])


def call_of(variant: str, x, xh, p, rows):
    """The call a variant times."""
    if variant in ("production", "full"):
        return lambda: kernels.fused_substep_scores(SPEC, x, xh, p, SPEC.A)
    if variant not in kernels.FUSED_CUTS:
        raise SystemExit(f"unknown variant {variant!r}")
    return lambda: breakdown.fused_cut(SPEC, x, xh, p, SPEC.A, variant, rows=rows)


def rows_of(variant: str, xh, p, rows):
    """The beam rows a work item of the variant's launch (None on the CPU);
    the production kernel takes its plan's whatever ``rows`` says."""
    if xh.device.type != "cuda":
        return None
    return breakdown.fused_cut_plan(SPEC, xh, p, SPEC.A,
                                    None if variant in ("production", "full") else rows).per_item


def run(variants, iters: int = 10, row_tiles=(None,), n: int = N, device=None,
        seed: int = 0) -> dict:
    """Times each variant at each rows a work item (None: the plan's) on
    ``n`` vectors; returns the JSON the script writes."""
    device = resolve_device(device)
    kw = make_inputs(seed, n)
    x, xh = (torch.from_numpy(kw[k]).to(device) for k in ("x", "xh"))
    p = step_params(kw, device)
    return time_variants(
        [ALIASES.get(v, v) for v in variants], lambda v, rows: call_of(v, x, xh, p, rows),
        lambda v, rows: rows_of(v, xh, p, rows), iters, row_tiles, device, KERNEL, n)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", type=str, default=DEFAULT_VARIANTS)
    ap.add_argument("--row-tiles", type=str, default=None,
                    help="beam rows a work item of the cuts, comma-separated (default: the plan's)")
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
