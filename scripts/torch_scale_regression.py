#!/usr/bin/env python
"""Scale regression with the PyTorch port: the whole search pipeline on a
synthetic clustered DB, one command (the port's counterpart of
scripts/scale_regression.py, with its flags, defaults and report).

Default scale: 10M vectors x D=128, ivf_K=2^16 -- the reference's own
smoke anchor, 10M/IVF65k (reference: qinco_v1/docs/IVF_search.md:61).
Runs, each task through ``python -m qinco_torch``'s ``main``:

  gen data -> ivf_centroids -> train -> encode trainset + db
  -> build_index -> validations -> train_pairwise_decoder
  -> search sweep -> Pareto check

The data come from the JAX script's numpy generators and seeds, so the
train, DB and query files are the same bytes; the exact top-100 ground
truth is computed on the device in f32.  A phase whose output exists is
skipped, so a second call goes on where the first stopped; the report
``scale_report.json`` is rewritten after every phase and keeps the
numbers of the phases an earlier call ran.  Besides the JAX report's keys
it holds ``device`` (the card's name and power limit, or ``cpu``),
``launches`` (each phase's kernel launches, where any), on the card
``expected_launches`` (what the phases that encode must launch) and
``peak_device_bytes`` (each phase's peak of allocated device memory).  On
the card, each encode phase must launch the selected-scores and
select-rebuild kernels exactly once per MLP step and chunk, and no other
beam-step kernel; training, once per MLP step of every step and validation
batch.  The IVF step's kernels (``kernels.NEAREST_KERNELS``), which the
k-means, the RQ bootstrap and every IVF encode launch, are reported and
not checked.

Usage:
  python scripts/torch_scale_regression.py [--out build/scale_regression] [--db-size 10000000]
      [--ivf-k 65536] [--epochs 2] [--cpu-search] [--device cuda|cpu]

Runs on the CUDA card; ``--device cpu`` runs every task with
``cpu=true`` and the script's own torch work on CPU tensors.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT), str(HERE)]  # qinco_torch, torch_timing

from qinco_torch.__main__ import main as qinco_main  # noqa: E402
from qinco_torch.config import load_config  # noqa: E402
from qinco_torch.ops.distances import (  # noqa: E402
    chunked_argmin,
    pairwise_sqdist_partial,
    topk_smallest,
)
from qinco_torch.ops.kernels import LAUNCHES, NEAREST_KERNELS  # noqa: E402
from qinco_torch.utils import host_to_device  # noqa: E402
from torch_timing import card  # noqa: E402

#: the kernels an encode or a train step under the parity profile launches
PARITY_KERNELS = ("selected_scores", "select_rebuild")
GT_K = 100


def log(*a):
    print("[scale]", *a, flush=True)


def gt_chunk(nq: int, device: torch.device) -> int:
    """DB rows a ground-truth chunk: a power of 2 whose (nq, chunk)
    distance tile, merged row and stable sort (values, int64 indices and
    the sort's buffers) take at most a quarter of the card's free memory,
    or 256 MiB on the CPU.  37 bytes an entry: the default run's
    ``gen_data`` peaked at 19.45 GB of allocated memory, 36.2 bytes an
    entry of its (4096, 2^17 + 100) merged tile, on an H100 80GB."""
    budget = torch.cuda.mem_get_info(device)[0] // 4 if device.type == "cuda" else 1 << 28
    rows = max(1, budget // (37 * nq))
    return 1 << max(10, min(20, rows.bit_length() - 1))


def exact_gt(queries: np.ndarray, db, device: torch.device, k: int = GT_K) -> np.ndarray:
    """Each query's ``k`` nearest DB rows by brute force in f32: partial
    distances ‖b‖² − 2 q·b of a DB chunk, merged with the running best by
    the stable ``topk_smallest``, so ties go to the smaller id."""
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(device)
    nq = len(q)
    best_d = torch.empty((nq, 0), device=device)
    best_i = torch.empty((nq, 0), dtype=torch.int32, device=device)
    chunk = gt_chunk(nq, device)
    for i in range(0, len(db), chunk):
        part = host_to_device(db[i:i + chunk], device)
        cand = torch.cat([best_d, pairwise_sqdist_partial(q, part)], dim=1)
        sel, best_d = topk_smallest(cand, k)
        # the top-k are views of the whole sort: copy them out, so that the
        # sort's outputs are freed before the next chunk
        sel, best_d = sel.contiguous(), best_d.contiguous()
        del cand
        # a winner left of the running best's width is a kept id, else a
        # row of this chunk
        kept = best_i.shape[1]
        new = (sel + (i - kept)).int()
        best_i = new if kept == 0 else torch.where(
            sel < kept, torch.gather(best_i, 1, sel.clamp(max=kept - 1)), new)
    return best_i.cpu().numpy()


def gen_data(out: Path, db_size: int, train_size: int, nq: int, d: int, device,
             seed=0, query_noise=1.0):
    """Clustered synthetic data (the JAX script's generators and seeds,
    byte for byte) + exact GT on the device."""
    rng = np.random.default_rng(seed)
    n_centers = 8192
    # the JAX script's geometry (scripts/frontier_tune.py): coarse recall
    # climbs gradually with nprobe
    centers = (rng.normal(size=(n_centers, d)) * 1.0).astype(np.float32)

    def sample(n, s, chunk=1_000_000):
        r = np.random.default_rng(s)
        parts = []
        for i in range(0, n, chunk):
            m = min(chunk, n - i)
            parts.append(
                centers[r.integers(0, n_centers, size=m)]
                + 1.5 * r.normal(size=(m, d)).astype(np.float32)
            )
        return np.concatenate(parts).astype(np.float32)

    log(f"generating train {train_size}, db {db_size}, queries {nq}")
    if not (out / "train.npy").exists():
        train = sample(train_size, 1)
        np.save(out / "train.npy", train)
        del train
    if not (out / "db.npy").exists():
        db = sample(db_size, 2)
        np.save(out / "db.npy", db)
    else:
        db = np.load(out / "db.npy", mmap_mode="r")
    if not (out / "queries.npy").exists():
        queries = np.asarray(db[
            np.sort(rng.integers(0, db_size, size=nq))
        ]) + query_noise * rng.normal(size=(nq, d)).astype(np.float32)
        np.save(out / "queries.npy", queries.astype(np.float32))
    else:
        queries = np.load(out / "queries.npy")

    if (out / "gt.npy").exists():
        return np.load(out / "gt.npy")
    log("computing exact ground truth on the device")
    del db  # the GT streams the saved file
    gt = exact_gt(queries, np.load(out / "db.npy", mmap_mode="r"), device)
    np.save(out / "gt.npy", gt)
    return gt


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def run_task(argv: list[str]) -> str:
    """``python -m qinco_torch`` on ``argv`` in this process; returns its log."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = qinco_main(argv)
    if rc != 0:
        raise RuntimeError(f"qinco_torch {argv[0]} returned {rc}")
    return tee.buf.getvalue()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "scale_regression")
    ap.add_argument("--db-size", type=int, default=10_000_000)
    ap.add_argument("--train-size", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=4096)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--ivf-k", type=int, default=65536)
    ap.add_argument("--kmeans-iters", type=int, default=100,
                    help="IVF coarse k-means iterations")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--cpu-search", action="store_true",
                    help="also run the search sweep with cpu=true "
                         "(the reference's timing protocol)")
    ap.add_argument("--cpu-only-sweep", action="store_true",
                    help="skip the device sweep; implies --cpu-search")
    ap.add_argument("--query-noise", type=float, default=1.0,
                    help="query displacement scale (x cluster noise 1.5)")
    ap.add_argument("--skip-gen", action="store_true")
    ap.add_argument("--dense-sweep", action="store_true",
                    help="96-point grid with the Pareto skip disabled")
    ap.add_argument("--tiny-model", action="store_true",
                    help="small explicit model args, default encode profile (CPU smoke)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default) or cpu: cpu=true for every task")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_scale_regression: no CUDA device; pass --device cpu to run "
                         "on the CPU")
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    report_path = out / "scale_report.json"
    earlier = json.loads(report_path.read_text()) if report_path.exists() else {}
    report: dict = {"config": vars(args) | {"out": str(out)},
                    "device": ", ".join(card(device).values()),
                    "phases": {}, "launches": {}, "expected_launches": {},
                    "peak_device_bytes": {}}
    cpu = ["cpu=true"] if not cuda else []

    if args.tiny_model:
        model_args = ["M=2", "K=16", "L=1", "de=8", "dh=12", "A=4", "B=2"]
        profile = []
    else:
        model_args = ["model_args=qinco2-S"]
        # exact in-kernel top-A and the fused select/rebuild: DB encode
        # quality feeds recall, so the binned speed profile stays out
        profile = ["encode_profile=parity"]
    cfg = load_config(model_args + profile)
    # with the IVF step 0, every one of the M codebooks carries an MLP
    n_mlp_steps, batch = int(cfg.M), int(cfg.batch)

    def save_report():
        merged = {**{k: v for k, v in earlier.items() if k != "config"}, **report}
        for key in ("phases", "launches", "expected_launches", "peak_device_bytes"):
            merged[key] = {**earlier.get(key, {}), **report[key]}
        tmp = report_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(merged, indent=2))
        tmp.replace(report_path)
        return merged

    def expect(name, per):
        """On the card under the parity profile: phase ``name`` launched
        the parity kernels ``per`` times each, and no other beam-step
        kernel (the IVF step's are not checked)."""
        if not cuda or args.tiny_model:
            return
        want = {k: per for k in PARITY_KERNELS}
        report["expected_launches"][name] = want
        save_report()
        beam = {k: v for k, v in report["launches"][name].items() if k not in NEAREST_KERNELS}
        if beam != want:
            raise RuntimeError(f"phase {name}: launches {report['launches'][name]}, "
                               f"expected {want}")

    def phase(name, fn):
        before = dict(LAUNCHES)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        r = fn()
        if cuda:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        report["phases"][name] = round(dt, 2)
        report["launches"][name] = {k: v - before[k] for k, v in LAUNCHES.items()
                                    if v != before[k]}
        report["peak_device_bytes"][name] = (
            torch.cuda.max_memory_allocated(device) if cuda else None)
        log(f"phase {name}: {dt:.1f}s")
        save_report()
        return r

    if not args.skip_gen or not (out / "gt.npy").exists():
        phase("gen_data", lambda: gen_data(
            out, args.db_size, args.train_size, args.nq, args.d, device,
            query_noise=args.query_noise,
        ))

    # 1. IVF centroids (k-means on the device)
    if not (out / "ivf.npy").exists():
        phase("ivf_centroids", lambda: run_task([
            "task=ivf_centroids", f"trainset={out}/train.npy",
            f"output={out}/ivf.npy", f"ivf_K={args.ivf_k}",
            f"kmeans_iters={args.kmeans_iters}",
            "ds.valset=10000", "verbose=true",
        ] + cpu))
        # k-means quality proxy: quantization MSE of a sample
        cents = np.load(out / "ivf.npy")
        sample = np.array(
            np.load(out / "train.npy", mmap_mode="r")[:65_536], np.float32
        )
        cents_dev = torch.from_numpy(cents).to(device)
        codes = torch.cat([
            chunked_argmin(torch.from_numpy(sample[i:i + 4096]).to(device), cents_dev,
                           chunk=16384)[0].cpu()
            for i in range(0, len(sample), 4096)
        ]).numpy()
        mse = float(((sample - cents[codes]) ** 2).sum(1).mean())
        report["kmeans_sample_mse"] = mse
        save_report()
        log(f"k-means sample quantization MSE/vector: {mse:g}")

    # 2. Train the IVF model (qinco2-S shapes)
    if not (out / "model.npz").exists():
        def train():
            text = run_task([
                "task=train", f"trainset={out}/train.npy",
                f"output={out}/model.npz", f"ivf_centroids={out}/ivf.npy",
            ] + model_args + [
                "ds.valset=10000", "ds.loop=500000", f"epochs={args.epochs}",
                "scheduler.stop_patience=0",
            ] + profile + cpu)
            steps = int(re.findall(r"Training done: (\d+) steps", text)[-1])
            n_val = len(re.findall(r"Validation metrics:", text))
            return steps + n_val * -(-10_000 // batch)

        batches = phase("train", train)
        expect("train", batches * n_mlp_steps)

    # 3. Encode trainset + DB
    for name, codes, n_rows, argv in (
            ("encode_trainset", out / "codes_train.npz",
             lambda: len(np.load(out / "train.npy", mmap_mode="r")),
             [f"trainset={out}/train.npy", "encode_trainset=true", "ds.valset=10000"]),
            ("encode_db", out / "codes_db.npz",
             lambda: len(np.load(out / "db.npy", mmap_mode="r")),
             [f"db={out}/db.npy"])):
        if codes.exists():
            continue
        phase(name, lambda argv=argv, codes=codes: run_task([
            "task=encode", f"model={out}/model.npz", f"ivf_centroids={out}/ivf.npy",
            *argv, f"output={codes}", "verbose=false"] + profile + cpu))
        expect(name, -(-n_rows() // batch) * n_mlp_steps)
        if name == "encode_db":
            report["encode_db_vecs_per_s"] = round(
                args.db_size / report["phases"]["encode_db"], 1
            )
            save_report()

    # 4. Build index
    if not (out / "index.qivf").exists():
        phase("build_index", lambda: run_task([
            "task=build_index", f"trainset={out}/train.npy",
            f"ivf_centroids={out}/ivf.npy",
            f"encoded_trainset={out}/codes_train.npz",
            f"encoded_db={out}/codes_db.npz",
            f"output={out}/index.qivf", "ds.valset=10000", "verbose=true",
        ] + cpu))

    # 5. Validations: HNSW-vs-exact coarse recall + int8 norm error
    def validations():
        from qinco_torch.ops.aq import reconstruct_from_codebooks
        from qinco_torch.search.index import HnswQuantizer, IvfIndex, coarse_probe

        cents = np.load(out / "ivf.npy")
        queries = np.load(out / "queries.npy")[:1024]
        exact_idx, _ = coarse_probe(torch.from_numpy(queries).to(device),
                                    torch.from_numpy(cents).to(device), 16)
        exact_idx = exact_idx.cpu().numpy()
        t0 = time.perf_counter()
        hnsw = HnswQuantizer.build(cents)
        report["hnsw_build_s"] = round(time.perf_counter() - t0, 2)
        hnsw_rec = {}
        for ef in (16, 64, 256):
            hidx, _ = hnsw.search(queries, 16, ef=ef)
            # fraction of exact top-16 lists found by HNSW
            hit = np.mean([
                len(set(a) & set(b)) / 16.0
                for a, b in zip(exact_idx, hidx)
            ])
            hnsw_rec[str(ef)] = round(float(hit), 4)
        report["hnsw_vs_exact_coarse_recall@16"] = hnsw_rec
        log(f"HNSW coarse recall@16 by efSearch: {hnsw_rec}")

        # int8 norm-quantization error, simulated with the native
        # quantizer's affine contract (native/ivf_index.cpp train_norm:
        # 255 levels over the [min, max] training range)
        codes = np.load(out / "codes_db.part_0.npz")["codes"][:200_000]
        index = IvfIndex.load(str(out / "index.qivf"), device=device)
        recons = reconstruct_from_codebooks(codes[:, 1:], index.codebooks)
        norms = (recons ** 2).sum(-1)
        lo, hi = norms.min(), norms.max()
        q = np.round((norms - lo) / max(hi - lo, 1e-20) * 255.0)
        deq = q / 255.0 * (hi - lo) + lo
        rel = np.abs(deq - norms) / np.maximum(norms.mean(), 1e-9)
        report["int8_norm_rel_err"] = {
            "mean": float(rel.mean()), "p99": float(np.quantile(rel, 0.99))
        }
        log(f"int8 norm relative error: mean={rel.mean():.2e} "
            f"p99={np.quantile(rel, 0.99):.2e}")

    phase("validations", validations)

    # 5.5 Pairwise additive mid-rerank decoder: the sweep exercises it
    # through its nmid_short > 1 operating points
    if not (out / "pairwise.npz").exists():
        phase("train_pairwise_decoder", lambda: run_task([
            "task=train_pairwise_decoder", f"trainset={out}/train.npy",
            f"ivf_centroids={out}/ivf.npy",
            f"encoded_trainset={out}/codes_train.npz",
            f"output={out}/pairwise.npz", "ds.valset=10000", "verbose=true",
        ] + cpu))

    # 6. Search sweep (device coarse probe + native scan)
    def search_sweep(cpu_sweep: bool):
        suffix = "_cpu" if cpu_sweep else ""
        if args.dense_sweep:
            grid = [
                "search.nprobe=[2,4,8,16,32,64,128,256]",
                "search.nshort=[3,10,30,100]",
                "search.nmid_short=[1,2,3]",
                "search.explore_all=true",
            ]
        else:
            grid = [
                "search.nprobe=[4,16,64]", "search.nshort=[10,100]",
                "search.nmid_short=[1,3]",
            ]
        cmd = [
            "task=search", f"model={out}/model.npz",
            f"ivf_centroids={out}/ivf.npy", f"index={out}/index.qivf",
            f"queries={out}/queries.npy", f"queries_gt={out}/gt.npy",
            f"pairwise_decoder={out}/pairwise.npz",
            f"output={out}/results{suffix}.json",
        ] + grid + [
            "search.quantizer_efSearch=[]",
            # nthreads=0: one OMP thread per core
            "search.nthreads=0",
            "verbose=true", "resume=true",
        ]
        if cpu_sweep or not cuda:
            cmd += ["cpu=true"]
        run_task(cmd)
        res = json.loads((out / f"results{suffix}.json").read_text())
        report[f"operating_points{suffix}"] = [
            {"parameters": r["parameters"], "R@1": r["recalls"]["1"],
             "R@10": r["recalls"]["10"], "R@100": r["recalls"]["100"],
             "t_total": r["t_total"]}
            for r in res["ivf_real_res"]
        ]
        return res

    res = None
    if not args.cpu_only_sweep:
        res = phase("search_sweep", lambda: search_sweep(False))
    res_cpu = None
    if args.cpu_search or args.cpu_only_sweep:
        res_cpu = phase("search_sweep_cpu", lambda: search_sweep(True))

    # 7. Pareto-prior ordering check: do the first-k explored points hit
    # the measured recall/time frontier?
    def pareto_check(res, tag):
        """Replay AdaptiveExplorer deterministically over the measured
        points (every pick's update uses the real measurement, as a live
        run would see it) and report what fraction of the true frontier
        the first-k explored points hit/cover."""
        from qinco_torch.search.operating_points import OperatingPoints
        from qinco_torch.search.optim_order import AdaptiveExplorer, sort_experiments_by_prior

        results = res["ivf_real_res"]
        by = {
            (r["parameters"]["nprobe"], r["parameters"]["nshort"],
             r["parameters"]["nmid_short"]): (r["recalls"]["1"], r["t_total"])
            for r in results
        }
        op2 = OperatingPoints()
        op2.add_range("nprobe", sorted({k[0] for k in by}))
        op2.add_range("nshort", sorted({k[1] for k in by}))
        op2.add_range("nmid_short", sorted({k[2] for k in by}))

        def run_order(pts):
            """Coverage stats for one exploration order: a frontier point
            counts as found once an early point is within recall -0.002
            and time x1.15 of it (near-tied frontier membership follows
            timing noise)."""
            frontier = [
                i for i, (rec, t) in enumerate(pts)
                if not any(r2 >= rec and t2 <= t and (r2 > rec or t2 < t)
                           for r2, t2 in pts)
            ]
            nf = max(len(frontier), 1)
            stats = {"frontier_size": len(frontier)}
            for mult in (1, 2):
                k = min(mult * nf, len(pts))
                stats[f"first_{mult}x_hit"] = round(
                    len(set(frontier) & set(range(k))) / nf, 3)
                cov = sum(
                    any(r2 >= rec - 0.002 and t2 <= t * 1.15
                        for r2, t2 in pts[:k])
                    for rec, t in (pts[i] for i in frontier)
                ) / nf
                stats[f"first_{mult}x_coverage"] = round(cov, 3)
            return frontier, stats

        # adaptive explorer replay (each update uses the real measurement)
        ex = AdaptiveExplorer(op2, op2.all_keys())
        pts_adaptive = []
        while True:
            key = ex.next()
            if key is None:
                break
            p = op2.get_parameters(key)
            m = by.get((p["nprobe"], p["nshort"], p["nmid_short"]))
            if m is None:
                continue  # grid point not measured
            ex.update(p, *m)
            pts_adaptive.append(m)
        frontier, stats_adaptive = run_order(pts_adaptive)

        # static prior ordering, for comparison
        pts_static = []
        for key in sort_experiments_by_prior(op2, op2.all_keys()):
            p = op2.get_parameters(key)
            m = by.get((p["nprobe"], p["nshort"], p["nmid_short"]))
            if m is not None:
                pts_static.append(m)
        _, stats_static = run_order(pts_static)

        report[f"pareto_prior{tag}"] = {
            "n_measured": len(pts_adaptive),
            "frontier_indices_in_explore_order": sorted(frontier),
            "adaptive_explorer": stats_adaptive,
            "static_prior": stats_static,
        }
        log(f"[{tag or 'device'}] frontier {sorted(frontier)} of "
            f"{len(pts_adaptive)}; adaptive {stats_adaptive} | "
            f"static {stats_static}")

    if res is not None:
        pareto_check(res, "")
    if res_cpu is not None:
        pareto_check(res_cpu, "_cpu")

    merged = save_report()
    log(f"report written to {report_path}")
    print(json.dumps({k: v for k, v in merged.items() if k != "config"}, indent=2))
    return merged


if __name__ == "__main__":
    main()
