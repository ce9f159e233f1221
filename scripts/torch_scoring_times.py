#!/usr/bin/env python
"""B2 and B4 at bf16 (the parity and speed profiles' scoring kernels) in a
checkout of this repository, on one CUDA card: for comparing two commits
back to back on the same card.

    python scripts/torch_scoring_times.py [CHECKOUT]   # default: this one

Imports ``qinco_torch`` and ``chip_smoke`` from CHECKOUT, builds its
kernels (into ``$QINCO_TORCH_BUILD_DIR`` if set) and prints one JSON line:
the ``ptxas`` registers and spills of the B2 and B4 libraries where this
run built them, and for each kernel at ``chip_smoke.py``'s kernel checks
(N = 1024 vectors, F_in = 32, A = 16, its random weights and inputs from
seed 0) the ms a call of 50 back-to-back calls and the device ms a launch
(torch.profiler, the mean of 50 more; ``torch_timing.time_calls``), with
the card's name and power limit: B2 and B4 at qinco2-S, B2 at qinco2-L
(``B2_L``, 10 calls), and B2's phase cuts ``full``, ``mlponly`` and
``shell`` at qinco2-S (``ops.breakdown.ktopa_variant``).  Run it on both
checkouts in turns (parent, change, change, parent).
"""

import json
import re
import sys
from pathlib import Path

root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent)
sys.path.insert(0, str(root.resolve()))

import torch  # noqa: E402
from torch_timing import card, time_calls  # noqa: E402

import chip_smoke as cs  # noqa: E402
from qinco_torch.ops import kernels  # noqa: E402

from qinco_torch.ops import breakdown  # noqa: E402


def _cut(mode):
    return lambda spec, x, xh, p, A: breakdown.ktopa_variant(spec, x, xh, p, A, mode)


B2 = "selected_scores_tc_kernel"
CASES = {  # name -> (preset, encode profile, wrapper, library, kernel, calls)
    "B2": ("qinco2-S", "parity", kernels.selected_scores, "selected_scores", B2, 50),
    "B4": ("qinco2-S", "speed", kernels.fused_substep_scores, "fused_substep_scores",
           "fused_substep_tc_kernel", 50),
    "B2_L": ("qinco2-L", "parity", kernels.selected_scores, "selected_scores", B2, 10),
    **{f"cut_{m}": ("qinco2-S", "parity", _cut(m), "ktopa_variants", B2, 50)
       for m in ("full", "mlponly", "shell")},
}


def ptxas(log: str, kernel: str) -> dict:
    """``ptxas -v``'s registers and spill stores of each entry function of
    ``log`` whose name holds ``kernel``."""
    found = {}
    for block in log.split("Compiling entry function '")[1:]:
        entry = block.split("'")[0]
        if kernel in entry:
            regs = re.search(r"Used \d+ registers", block)
            spills = re.search(r"\d+ bytes spill stores", block)
            found[entry] = [m.group(0) for m in (regs, spills) if m]
    return found


def main() -> None:
    dev = torch.device("cuda")
    reports = kernels.build()
    out = {"checkout": str(root), "card": card(dev)}
    for name, (preset, profile_name, fn, lib, kernel, calls) in CASES.items():
        spec = cs.spec_of(preset, profile=profile_name)
        p, x, xh = cs.step_inputs(spec, 1024, spec.B, 0, dev)

        def call():
            return fn(spec, x, xh, p, spec.A)

        ms_call, launch_ms = time_calls(call, calls, dev, kernel)
        out[name] = {"launch_ms": launch_ms, "ms_call": ms_call}
        if lib in reports:  # each tensor-core instantiation: its registers and spills
            out[name]["ptxas"] = ptxas(reports[lib], kernel)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
