"""Times the bf16 fused-substep (B4) and candidate-scores (B5) kernels on one
CUDA card under every launch plan whose shared memory fits: MLP tile TM of
128 or 64 pairs, R = 32, 16, 8 or 4 rows a work item.

    python scripts/torch_scoring_plans.py      # needs a CUDA card

Shapes: chip_smoke.py's kernel checks (N = 1024 vectors, its random
weights and inputs): B4 at the qinco2-S speed step, its IVF first step, the
qinco2-M widths and, with fold_up=false, the folded-W1 table at the
qinco2-S step; B5 at K = 1024 with the qinco2-S widths.  Every plan
must give the default plan's output bit for bit (the tiling changes no
sum).  One JSON line per (kernel, shape, plan): ms a launch from CUDA
events around back-to-back launches on operands prepared once (the
wrapper's host work excluded), the median of 7 windows of 20, with the
card's name and power limit first.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]
from chip_smoke import spec_of, step_inputs  # noqa: E402

from qinco_torch.ops import kernels  # noqa: E402

TILES, ROWS = (128, 64), (32, 16, 8, 4)


def launch_ms(fn, calls: int = 20, windows: int = 7) -> float:
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


def sweep(name, shape, default, smem_of, n_rows, launch) -> None:
    """Each fitting (TM, R) against the default plan's output and time."""
    want = launch(default)
    for tm in TILES:
        for R in ROWS:
            smem = smem_of(R, tm)
            if smem > kernels._SMEM_LIMIT:
                continue
            items = -(-n_rows // R)
            plan = kernels.LaunchPlan(tm, R, smem, items, min(items, kernels._SMS), True)
            got = launch(plan)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} {shape} tm={tm} R={R}: output differs from the default")
            print(json.dumps(dict(kernel=name, shape=shape, tm=tm, R=R, smem=smem, items=items,
                                  default=(tm, R) == (default.tm, default.per_item),
                                  ms=launch_ms(lambda: launch(plan)))), flush=True)


def fused(shape, spec, F_in, A, device) -> None:
    p, x, xh = step_inputs(spec, 1024, F_in, 0, device)
    w = kernels.fused_weights(spec, p, kernel=True)
    default = kernels.fused_launch_plan(spec, xh, w, A)
    sweep("fused_substep_scores", shape, default,
          lambda R, tm: kernels._fused_mma_smem(R, tm, A, spec.D, spec.K, w.De, w.Dh, w.Wc,
                                                w.layout, w.has_in_proj),
          xh.shape[0], lambda plan: kernels._fused_launch(spec, x, xh, w, A, F_in, plan))


def candidate(shape, spec, F_in, A, device) -> None:
    p, x, xh = step_inputs(spec, 1024, F_in, 0, device)
    x_f = x.repeat_interleave(F_in, 0)
    g = torch.Generator(device=device).manual_seed(3)
    idx = torch.randint(0, spec.K, (xh.shape[0], A), generator=g, device=device,
                        dtype=torch.int32)
    w = kernels.chain_weights(spec, p, kernel=True)
    book = p.codebook.to(torch.bfloat16).contiguous()
    default = kernels.candidate_launch_plan(spec, xh, idx, w)
    sweep("candidate_scores", shape, default,
          lambda R, tm: kernels._candidate_mma_smem(R, tm, A, spec.D, w.De, w.Dh, w.Wc,
                                                    w.in_proj is not None, w.low_rank),
          xh.shape[0],
          lambda plan: kernels._candidate_launch(spec, x_f, xh, idx, book, w, spec.K <= 256,
                                                 plan))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_scoring_plans: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    s = spec_of("qinco2-S")
    speed_s, speed_m = spec_of("qinco2-S", profile="speed"), spec_of("qinco2-M", profile="speed")
    fused("qinco2-S speed", speed_s, s.B, s.A, device)
    fused("qinco2-S speed IVF first step", speed_s, 1, max(s.B, s.A), device)
    fused("qinco2-M speed", speed_m, speed_m.B, speed_m.A, device)
    fused("qinco2-S speed fold_up=false", spec_of("qinco2-S", "fold_up=false", profile="speed"),
          s.B, s.A, device)
    candidate("qinco2-S widths K=1024", spec_of("qinco2-S", "K=1024"), s.B, s.A, device)


if __name__ == "__main__":
    main()
