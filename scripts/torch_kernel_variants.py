#!/usr/bin/env python
"""Phase timings of B4, the fused-substep scoring kernel (the speed
profile), and of the script's other experiments, on a CUDA card: the
PyTorch port's counterpart of scripts/kernel_variants.py.

    python scripts/torch_kernel_variants.py [--variants full,sel,self]
        [--iters 10] [--row-tiles 16,32] [--n 4096] [--out variants.json]
        [--device cuda|cpu] [--seed 0]

Shapes and inputs are the JAX script's: qinco2-S widths (D = de = 128,
dh = 256, K = 256, L = 2, A = 16, B = 32, bf16) with its random in and
out projections (D x de, de x D), N = 4096 vectors (N·B = 131072 beam
rows), the arrays of its make_inputs (numpy normal x 0.1 from the seed,
in its order); ``bw`` reads its own N·B x D standard normal rows.
``--variants`` takes every name of the JAX script's main() and runs what
the script runs for it (the names it prints, left; what is timed here,
right):

- ``full``, ``full512``, ``full128``: ``full`` =
  ``kernels.fused_substep_scores``, B4 as the encode runs it (the script's
  production kernel at its row tiles of 256, 512, 128);
- ``perbin`` (``perbin@512``, ``perbin@256``), ``sgfetch`` (``sg8@256``,
  ``sg4@256``, ``sg4@512``): ``full``.  perbin_kernel and sgfetch_kernel
  compute B4's function through TPU layouts of its fetch; the card's B4
  gathers by id, so they are its kernel, timed once as ``full``;
  ``sgcheck`` (``sg8check``, ``sg4check``) holds that kernel against its
  plain version at min(N, 128) vectors, as the script holds sgfetch
  against production (B4's limits: ids on >= 98%, rtol 1e-2);
- ``sel``, ``selrt`` (``sel@rt512``, ``sel@rt1024``, ``sel@rt2048``):
  ``sel``; ``self`` or ``sel+fetch``, ``fetchb``: ``sel+fetch``; ``dsub``,
  ``mlponly``, ``fullopt`` (and ``fullopt@512``): the cuts of
  ``qinco_torch.ops.breakdown.fused_cut`` (that module says what each
  computes);
- ``selected`` (``selected@256``, ``selected@512``; ``selected-ko``):
  ``selected``, B2' (``kernels.selected_scores`` with external vals) on
  the exact top-A of the f32 substep distances computed in the call, and
  ``selected-ko``, the kernel on vals computed once;
- ``selcat`` (``selcat@256``, ``selcat@512``): ``selcat``,
  ``breakdown.selcat`` on vals computed in the call;
- ``noop`` (``noop``, ``noop@rt512``, ``noop@rt2048``) and ``bw`` (``bw
  f32@rt512`` ... ``bw bf16@rt2048``): ``noop@rt256``, ``noop@rt512``,
  ``noop@rt2048``, ``bw_f32@rt512`` ..., ``breakdown.stream_probe`` with
  the row tile as the rows of a block; ``bw`` also prints GB/s of xh read,
  as the script does.
``production`` times B4 too, under its own name.

A row tile of the script other than a streaming probe's has no
counterpart on the card, whose work items hold at most 32 beam rows:
those names map to the launch plan's rows, which the key of each timing
(``<variant>@R<rows>``) says.  Each timed variant runs ``--iters``
back-to-back calls after a warm-up call, timed between two CUDA events
(``ms_per_step``: each call includes its wrapper's weight casts and,
where the kernel is shorter, its host work), then ``--iters`` more under
torch.profiler (``kernel_ms``: the device ms a launch of the kernel
alone).  ``--row-tiles`` sets the beam rows of a work item of the cuts
and of ``selcat`` (powers of 2 up to 32; default the plan's, 16 at these
shapes), not of the production kernels.  Prints one line a timed variant
and writes JSON (``utc``, ``batch``, ``ms_per_step``, ``kernel_ms``,
``names``: each printed name's timed variant, ``checks``, ``gb_per_s``,
``device``: the card's name and power limit).  Runs on the card unless
``--device cpu`` is given (there the plain versions, timed by the host
clock).
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
DEFAULT_VARIANTS = "full,sel,self"
CHECK_N = 128  # vectors of sgcheck, as the JAX script's check
# The JAX script's --variants names -> (the name it prints, the variant
# timed here), in its order; sgcheck's names are checks, not timings.
RUNS = {
    "production": [("production", "production")],
    "full": [("full", "full")], "full512": [("full512", "full")],
    "full128": [("full128", "full")],
    "selected": [("selected@256", "selected"), ("selected@512", "selected"),
                 ("selected-ko", "selected-ko")],
    "selcat": [("selcat@256", "selcat"), ("selcat@512", "selcat")],
    "sel": [("sel", "sel")],
    "selrt": [(f"sel@rt{rt}", "sel") for rt in (512, 1024, 2048)],
    "dsub": [("dsub", "dsub")],
    "noop": [("noop", "noop@rt256"), ("noop@rt512", "noop@rt512"),
             ("noop@rt2048", "noop@rt2048")],
    "self": [("sel+fetch", "sel+fetch")], "sel+fetch": [("sel+fetch", "sel+fetch")],
    "bw": [(f"bw {t}@rt{rt}", f"bw_{t}@rt{rt}") for t in ("f32", "bf16") for rt in (512, 2048)],
    "fetchb": [("fetchb", "sel+fetch")],
    "perbin": [("perbin@512", "full"), ("perbin@256", "full")],
    "sgfetch": [("sg8@256", "full"), ("sg4@256", "full"), ("sg4@512", "full")],
    "sgcheck": [("sg8check", None), ("sg4check", None)],
    "fullopt": [("fullopt", "fullopt"), ("fullopt@512", "fullopt")],
    "mlponly": [("mlponly", "mlponly")],
}


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


def external_vals(x, xh, p) -> torch.Tensor:
    """The script's selection for ``selected`` and ``selcat`` (:585-600,
    :692-700): the packed f32 substep distances ||C||^2 - 2 (x - xh)·C, the
    A smallest of each row, ascending (exact here, approx_max_k there)."""
    r = x.repeat_interleave(SPEC.B, 0) - xh
    sub = p.sub_codebook
    ids = torch.arange(SPEC.K, dtype=torch.int32, device=x.device)[None, :]
    packed = kernels.pack_ids_f32((sub * sub).sum(1) - 2.0 * (r @ sub.T), ids)
    return torch.topk(packed, SPEC.A, dim=1, largest=False).values.contiguous()


def expand(names) -> list:
    """The (printed name, timed variant) pairs of ``--variants`` names;
    a timed variant's own name is taken as it is."""
    timed = {v for runs in RUNS.values() for _, v in runs if v}
    out = []
    for name in names:
        if name in RUNS:
            out += RUNS[name]
        elif name in timed:
            out.append((name, name))
        else:
            raise SystemExit(f"unknown variant {name!r}")
    return out


def kernel_of(variant: str) -> str:
    """The kernel a timed variant launches once a call."""
    if variant.startswith("noop"):
        return "stream_noop_kernel"
    if variant.startswith("bw"):
        return "stream_bw_kernel"
    if variant in ("selected", "selected-ko", "selcat"):
        return "selected_scores_tc_kernel"
    return "fused_substep_tc_kernel"


def _probe(variant: str):
    """(kind, input, rows) of a streaming probe's timed name."""
    kind, rt = variant.split("@rt")
    return kind.split("_")[0], kind, int(rt)


class Case:
    """The script's operands on ``device`` at ``n`` vectors from ``seed``."""

    def __init__(self, n: int, device, seed: int):
        kw = make_inputs(seed, n)
        self.x, self.xh = (torch.from_numpy(kw[k]).to(device) for k in ("x", "xh"))
        self.p = step_params(kw, device)
        bw = np.random.default_rng(seed).normal(size=(n * SPEC.B, SPEC.D)).astype(np.float32)
        bw = torch.from_numpy(bw).to(device)
        self.bw = {"bw_f32": bw, "bw_bf16": bw.to(torch.bfloat16)}
        self._vals = None

    def vals(self) -> torch.Tensor:
        if self._vals is None:
            self._vals = external_vals(self.x, self.xh, self.p)
        return self._vals

    def call(self, variant: str, rows):
        """The call a timed variant times."""
        x, xh, p, A = self.x, self.xh, self.p, SPEC.A
        selected = SPEC.with_(fused_substep=False)
        if variant in ("production", "full"):
            return lambda: kernels.fused_substep_scores(SPEC, x, xh, p, A)
        if variant in kernels.FUSED_KERNELS:
            return lambda: breakdown.fused_cut(SPEC, x, xh, p, A, variant, rows=rows)
        if variant == "selected":
            return lambda: kernels.selected_scores(selected, x, xh, p, A, external_vals(x, xh, p))
        if variant == "selected-ko":
            vals = self.vals()
            return lambda: kernels.selected_scores(selected, x, xh, p, A, vals)
        if variant == "selcat":
            return lambda: breakdown.selcat(SPEC, x, xh, p, external_vals(x, xh, p), rows=rows)
        kind, name, rt = _probe(variant)
        data = xh if kind == "noop" else self.bw[name]
        return lambda: breakdown.stream_probe(data, kind, rt, A)

    def rows(self, variant: str, rows):
        """The beam rows a work item of the variant's launch (None on the
        CPU, and for the streaming probes, whose name says their rows);
        the production kernels take their plan's whatever ``rows`` says."""
        xh, p, A = self.xh, self.p, SPEC.A
        if xh.device.type != "cuda" or variant.startswith(("noop", "bw")):
            return None
        if variant in ("production", "full"):
            return breakdown.fused_cut_plan(SPEC, xh, p, A).per_item
        if variant in kernels.FUSED_KERNELS:
            return breakdown.fused_cut_plan(SPEC, xh, p, A, rows, variant).per_item
        if variant == "selcat":
            return breakdown.selcat_plan(SPEC, xh, p, A, rows).per_item
        stages = 2 + 2 * SPEC.L + 1  # B2' under the script's spec: W2, wfold, the FFN, out_proj
        return kernels.selected_plan(len(xh), A, SPEC.D, SPEC.K, SPEC.De, SPEC.dh, bf16=True,
                                     topa=False, stages=stages,
                                     sms=kernels.sm_count(xh.device)).per_item


def sg_check(n: int, device, seed: int) -> dict:
    """sgfetch's function (production B4's) on the card against its plain
    version at ``n`` vectors: B4's limits (ids on >= 98% of slots, rtol
    1e-2 where they agree)."""
    c = Case(n, device, seed)
    got = kernels.fused_substep_scores(SPEC, c.x, c.xh, c.p, SPEC.A)
    want = kernels.fused_substep_scores_plain(SPEC, c.x, c.xh, c.p, SPEC.A)
    same = kernels.unpack_ids(got) == kernels.unpack_ids(want)

    def unpacked(v):
        return (v.view(torch.int32) & ~0xFF).view(torch.float32)[same]

    g, w = unpacked(got), unpacked(want)
    agree = same.float().mean().item()
    ok = agree >= 0.98 and bool(((g - w).abs() <= 1e-2 * w.abs() + 1e-4).all())
    return {"ok": ok, "ids_agree": agree, "max_abs_diff": (g - w).abs().max().item()}


def run(variants, iters: int = 10, row_tiles=(None,), n: int = N, device=None,
        seed: int = 0) -> dict:
    """Times each variant of ``variants`` (the JAX script's names) at each
    rows a work item (None: the plan's) on ``n`` vectors, and runs its
    checks; returns the JSON the script writes."""
    device = resolve_device(device)
    pairs = expand(variants)
    checks = {}
    for printed, v in pairs:
        if v is None:
            checks[printed] = sg_check(min(n, CHECK_N), device, seed)
            ok = "OK" if checks[printed]["ok"] else "MISMATCH"
            print(f"{printed}: check {ok} (max abs diff {checks[printed]['max_abs_diff']:.3e})",
                  flush=True)
    timed = list(dict.fromkeys(v for _, v in pairs if v))
    case = Case(n, device, seed)
    res = time_variants(timed, case.call, case.rows, iters, row_tiles, device, kernel_of, n)
    res["names"] = {printed: v for printed, v in pairs if v}
    res["checks"] = checks
    res["gb_per_s"] = {}
    for key, ms in res["ms_per_step"].items():
        if key.startswith("bw") and isinstance(ms, float):
            data = case.bw[key.split("@")[0]]
            t = res["kernel_ms"].get(key) or ms
            res["gb_per_s"][key] = data.numel() * data.element_size() / 1e6 / t
            print(f"{key}: {res['gb_per_s'][key]:.0f} GB/s", flush=True)
    if any(not c["ok"] for c in checks.values()):
        raise SystemExit(f"sgcheck: mismatch {checks}")
    return res


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
