#!/usr/bin/env python
"""Encode-profile MSE deltas on a trained checkpoint, with the PyTorch
port (the counterpart of scripts/trained_mse_check.py).

Reads ``model.npz`` and ``queries.npy`` of a scale run's output directory
(``scripts/torch_scale_regression.py --out DIR``, or the JAX script's:
the checkpoint format is shared) and prints the MSE of the first ``--n``
queries under the exact profile and each route of the JAX script, with
its change against exact, then the bin-diversified relabelling of
``scripts/binperm_experiment.py`` (a numpy copy of its ``diverse_perm``):
exact after the relabelling (an invariance check, since MSE does not
depend on codeword labels) and the binned speed route on the relabelled
weights.

As in the JAX script, the queries enter ``encode`` as they are stored,
without the checkpoint's normalization, so the figures compare with its
record.  On the card the routes run these kernels (the launches of each are printed):

- ``exact``: no kernel (the plain f32 beam search);
- ``xla_fast (approxA)``: no kernel; ``approx_max_k`` has no counterpart
  on the card and is an exact top-A there, as on the CPU;
- ``fast+pallas (extA)``, ``selected_fsel (ext)``: selected scores with
  external vals (the exact top-A outside the kernel) and select-rebuild;
- ``ktopa``, ``ktopa_fsel``: selected scores with the in-kernel exact
  top-A and select-rebuild (the parity profile);
- ``fused_substep``, ``fused+perbin``, ``perbin_fsel``: fused-substep
  scores (the speed profile) and select-rebuild.
``fused_select`` and ``perbin`` select TPU layouts and have no effect on
the card: those rows run their base route, and say so.

Usage:
  python scripts/torch_trained_mse_check.py --dir DIR [--n 2048] [--out mse.json]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT), str(HERE)]  # qinco_torch, torch_timing

from qinco_torch.checkpoint import load_checkpoint, load_checkpoint_meta  # noqa: E402
from qinco_torch.models.qinco import encode  # noqa: E402
from qinco_torch.models.spec import QincoSpec  # noqa: E402
from qinco_torch.ops.kernels import LAUNCHES  # noqa: E402
from torch_timing import card  # noqa: E402

BF16 = dict(fast=True, compute_dtype="bfloat16")
# (tag, spec overrides on exact, the card's departure from the TPU route)
ROUTES = [
    ("xla_fast (approxA)", BF16, "approx_max_k runs as an exact top-A"),
    ("fast+pallas (extA)", dict(BF16, pallas=True, fused_topa=False), None),
    ("ktopa (exact topA)", dict(BF16, pallas=True), None),
    ("ktopa_fsel", dict(BF16, pallas=True, fused_select=True),
     "fused_select has no effect: the ktopa route"),
    ("fused_substep", dict(BF16, pallas=True, fused_substep=True), None),
    ("fused+perbin", dict(BF16, pallas=True, fused_substep=True, perbin=True),
     "perbin has no effect: the fused_substep route"),
    ("selected_fsel (ext)", dict(BF16, pallas=True, fused_topa=False, fused_select=True),
     "fused_select has no effect: the extA route"),
    ("perbin_fsel", dict(BF16, pallas=True, fused_substep=True, perbin=True, fused_select=True),
     "perbin, fused_select have no effect: the fused_substep route"),
]
CHUNK = 1024


def balanced_clusters(C: np.ndarray, n_clusters: int, iters: int = 25,
                      seed: int = 0) -> np.ndarray:
    """Balanced k-means: (K, D) rows -> cluster labels with exactly
    K/n_clusters members each (greedy nearest-fill assignment)."""
    K = C.shape[0]
    cap = K // n_clusters
    rng = np.random.default_rng(seed)
    cent = C[rng.choice(K, n_clusters, replace=False)].copy()
    labels = np.zeros(K, np.int64)
    for _ in range(iters):
        d = ((C[:, None, :] - cent[None]) ** 2).sum(-1)  # (K, nc)
        # visit rows by their best-distance margin, fill clusters to capacity
        order = np.argsort(d.min(1))
        counts = np.zeros(n_clusters, np.int64)
        for i in order:
            for c in np.argsort(d[i]):
                if counts[c] < cap:
                    labels[i] = c
                    counts[c] += 1
                    break
        for c in range(n_clusters):
            cent[c] = C[labels == c].mean(0)
    return labels


def diverse_perm(C: np.ndarray, A: int, seed: int = 0) -> np.ndarray:
    """Permutation perm (K,) s.t. bins perm[i*G:(i+1)*G] each contain one
    member per balanced similarity cluster."""
    K = C.shape[0]
    G = K // A
    labels = balanced_clusters(C, n_clusters=G, seed=seed)  # G clusters of A
    bins = [[] for _ in range(A)]
    for c in range(G):
        members = np.flatnonzero(labels == c)  # A members
        for slot, m in enumerate(members):
            bins[slot].append(m)
    perm = np.concatenate([np.asarray(b) for b in bins])
    assert sorted(perm.tolist()) == list(range(K))
    return perm.astype(np.int32)


def run(directory, n: int = 2048, device: str = "cuda") -> dict:
    """The MSE of each route on the first ``n`` queries of ``directory``."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_trained_mse_check: no CUDA device; pass --device cpu to run "
                         "on the CPU")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    meta = load_checkpoint_meta(f"{directory}/model.npz")
    hp = meta["parameters"]
    print("checkpoint hyperparams:", hp, flush=True)
    exact = QincoSpec(
        D=meta["data_dim"], K=hp["K"], M=hp["M"], L=hp["L"],
        de=hp.get("de"), dh=hp["dh"], A=hp.get("A") or 0, B=hp.get("B") or 1,
        ivf_K=hp.get("ivf_K") or 0,
    )
    params = load_checkpoint(f"{directory}/model.npz", exact, device=dev)["params"]
    x = np.load(f"{directory}/queries.npy", mmap_mode="r")[:n]
    x = torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    def mse(spec, p):
        before = dict(LAUNCHES)
        err = sum(float(((xc - encode(p, spec, xc)[1]) ** 2).sum())
                  for xc in x.split(CHUNK))
        launched = {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}
        return err / len(x), launched

    res = {"device": card(dev), "n": len(x), "routes": {}}
    m_exact, _ = mse(exact, params)
    res["exact"] = m_exact
    print(f"exact                  {m_exact:.4f}", flush=True)
    for tag, kw, note in ROUTES:
        m, launched = mse(exact.with_(**kw), params)
        res["routes"][tag] = dict(mse=m, delta_pct=100 * (m / m_exact - 1), launches=launched,
                                  card_route=note)
        print(f"{tag:22s} {m:.4f}  ({100 * (m / m_exact - 1):+.3f}%)  {json.dumps(launched)}"
              + (f"  [{note}]" if note else ""), flush=True)

    # bin-diversification: relabel each step's codewords so that similar
    # words land in different bins
    steps = params.steps
    n_steps = steps.sub_codebook.shape[0]
    perms = [torch.from_numpy(diverse_perm(steps.sub_codebook[m].cpu().numpy(), exact.A, seed=m))
             .to(dev).long() for m in range(n_steps)]
    permuted = params._replace(steps=steps._replace(
        codebook=torch.stack([steps.codebook[m][perms[m]] for m in range(n_steps)]),
        sub_codebook=torch.stack([steps.sub_codebook[m][perms[m]] for m in range(n_steps)]),
    ))
    m_inv, _ = mse(exact, permuted)
    m_dv, launched = mse(exact.with_(**ROUTES[4][1]), permuted)
    res["exact_after_perm"] = m_inv
    res["fused_diverse"] = dict(mse=m_dv, delta_pct=100 * (m_dv / m_exact - 1),
                                launches=launched)
    print(f"exact after perm       {m_inv:.4f} (invariance check)", flush=True)
    print(f"fused+diverse          {m_dv:.4f}  ({100 * (m_dv / m_exact - 1):+.3f}%)", flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", type=str, default=str(ROOT / "build" / "scale_regression"))
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--out", type=Path, help="also write the results as JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    res = run(args.dir, args.n, args.device)
    if args.out:
        args.out.write_text(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
