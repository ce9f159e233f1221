"""How far the port's select-rebuild kernel and its plain version each are
from sums exact to float64, on the CUDA tests' inputs, at bf16.

    python scripts/torch_rebuild_accuracy.py      # needs a CUDA card

For the qinco2-S, -M and -L widths (the CASES of tests/test_torch_cuda.py,
N = 70 vectors, its weights and inputs), prints max and mean |difference|
of the reconstructions between: the kernel and the plain version (what
the CUDA test checks), the plain version (cuBLAS, f32) and the exact
reference, the kernel and the exact reference.  The exact reference is
the plain step MLP with every product summed in float64 and rounded to
float32, then to bf16 at the same points.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
from test_torch_cuda import CASES, _inputs, _step  # noqa: E402
from torch_exact import rebuild_exact  # noqa: E402

from qinco_torch.ops import kernels  # noqa: E402


def _stats(e: torch.Tensor) -> str:
    return f"max {e.max().item():.4g} mean {e.mean().item():.3g}"


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_rebuild_accuracy: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for case in ("S", "M", "L"):
        widths, F_in, n_codes = CASES[case]
        spec, p = _step(widths, "bfloat16", seed=3, device=dev)
        x, xh = _inputs(spec, F_in, N=70, seed=4, device=dev)
        N = x.shape[0]
        dists = kernels.selected_scores_plain(spec, x, xh, p, n_codes).reshape(N, F_in * n_codes)
        dists[:, n_codes:2 * n_codes] = dists[:, :n_codes]  # as the test: ties across beams
        F_out = min(spec.B, F_in * n_codes)
        xk, ck, pk = kernels.select_rebuild(spec, dists, xh, p, n_codes, F_out)
        xp, cp, pp = kernels.select_rebuild_plain(spec, dists, xh, p, n_codes, F_out)
        xe = rebuild_exact(spec, p, xh, cp, pp)
        same = torch.equal(ck, cp) and torch.equal(pk, pp)
        print(f"{case}: codes and parents equal {same}; kernel-plain {_stats((xk - xp).abs())}; "
              f"plain-exact {_stats((xp - xe).abs())}; kernel-exact {_stats((xk - xe).abs())}",
              flush=True)


if __name__ == "__main__":
    main()
