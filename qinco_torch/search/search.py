"""Search loops (counterpart of ``qinco_tpu/search/search.py``): the
flat search of a small database, and the IVF pipeline of the QINCo2
paper's Fig. 3 — coarse shortlist, optional pairwise mid-rerank, QINCo
decode and exact rerank, recall@{1,10,100} — over a Pareto-pruned grid of
operating points with a JSON resume.

The query-side products, the decode and the top-k run on the task's
device; the inverted-list scan is the native library.  Top-k selections
take a stable sort, so ties go to the smaller position as in
``lax.top_k``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..metrics import compute_recalls
from ..models.qinco import decode_raw, encode_chunked
from ..ops.distances import pairwise_sqdist_partial, topk_smallest
from ..utils import Timer, TimersManager
from .operating_points import OperatingPoints
from .optim_order import AdaptiveExplorer, sort_experiments_by_prior

# Decoded shortlist rows per block of queries: 2^19 rows of D=128 f32 are 256 MB.
DECODE_BLOCK_ROWS = 1 << 19


def run_search_flat(task):
    """Encode the database, decode it, and rank it for every query
    (recall@{1,10,100} of the top 100)."""
    cfg = task.cfg
    params, spec, device = task.params, task.spec, task.device
    log = task.print
    timer = Timer()
    with timer:
        log(f"[{timer}] Encoding database")
        codes = torch.as_tensor(encode_chunked(params, spec, task.db, batch=cfg.batch),
                                device=device)
        bs = cfg.search.batch_size
        db_dec = torch.cat([decode_raw(params, spec, codes[:, i:i + bs])
                            for i in range(0, codes.shape[1], bs)])
        log(f"[{timer}] Encoding done ({tuple(db_dec.shape)})")

        log(f"[{timer}] Computing top query answers")
        xq = np.array(task.xq, np.float32)  # a writable copy of a memmap
        qbs = min(100, cfg.batch)
        I = np.concatenate([
            topk_smallest(pairwise_sqdist_partial(
                torch.as_tensor(xq[i:i + qbs], device=device), db_dec), 100)[0].cpu().numpy()
            for i in range(0, len(xq), qbs)])
        recalls = compute_recalls(I, np.asarray(task.xq_gt))
        log(f"R@1={recalls[1] * 100:.2f}    R@10={recalls[10] * 100:.2f}    "
            f"R@100={recalls[100] * 100:.2f}")
    return recalls


@torch.no_grad()
def _fused_shortlist_topk(params, spec, codes_int32: np.ndarray, xq: np.ndarray, topk: int,
                          q_block: int = 2048) -> np.ndarray:
    """Decode each query's shortlist ``codes_int32 (nq·ns, M + 1)``, score
    it against the query and keep the ``topk`` nearest positions, a block
    of ``q_block`` queries at a time on the parameters' device; only the
    ``(nq, topk)`` int32 positions come back."""
    device = params.codebook0.device
    nq, D = xq.shape
    ns = len(codes_int32) // nq
    codes3 = codes_int32.reshape(nq, ns, -1)
    out = np.empty((nq, topk), np.int32)
    for q0 in range(0, nq, q_block):
        cb = torch.as_tensor(codes3[q0:q0 + q_block], device=device)
        xb = torch.as_tensor(np.asarray(xq[q0:q0 + q_block], np.float32), device=device)
        nv = cb.shape[0]
        xhat = decode_raw(params, spec, cb.reshape(nv * ns, -1).T)
        d = ((xb[:, None, :] - xhat.reshape(nv, ns, D)) ** 2).sum(-1)
        out[q0:q0 + nv] = topk_smallest(d, topk)[0].int().cpu().numpy()
    return out


def run_search_ivf(task):
    """The IVF search over the grid ``search.nprobe`` × ``nshort`` ×
    ``nmid_short`` (and ``quantizer_efSearch``), explored by
    :class:`AdaptiveExplorer`, each point run once untimed (warm-up) and
    once timed; results go to the JSON ``output`` after every point."""
    from .index import IvfIndex

    cfg = task.cfg
    log = task.print
    device = task.device
    index = IvfIndex.load(cfg.index, device=device)
    params, spec = task.params, task.spec
    if str(cfg.search.get("coarse", "tpu")) == "hnsw":
        efc = int(cfg.search.get("quantizer_efConstruction", 20))
        log(f"Building native HNSW coarse quantizer (efConstruction={efc})")
        index.use_hnsw(ef_construction=efc)
    if bool(cfg.search.get("split_lut", True)):
        budget = int(float(cfg.search.get("split_lut_max_gb", 4)) * (1 << 30))
        if index.enable_split_lut(max_bytes=budget):
            log("Split-LUT scan enabled (precomputed per-centroid tables)")
        else:
            log("Split-LUT tables over budget; classic per-probe LUTs")

    mid_reranker = None
    if cfg.pairwise_decoder:
        from .pairwise_decoder import PairwiseDecoder

        mid_reranker = PairwiseDecoder.load(cfg.pairwise_decoder, device=device)
        log(f"Will use pairwise mid-reranker from {cfg.pairwise_decoder}")

    xq = np.array(task.xq, np.float32)  # a writable copy of a memmap
    gt = np.asarray(task.xq_gt)
    nq = len(xq)
    M = cfg.M

    seen_parameters, ivf_real_res = [], []
    json_results = {"ivf_real_res": ivf_real_res}
    if cfg.resume and cfg.output and Path(cfg.output).exists():
        with open(cfg.output) as sf:
            json_results = json.load(sf)
        ivf_real_res = json_results["ivf_real_res"]
        seen_parameters = [r["parameters"] for r in ivf_real_res]
        log(f"Resuming: {len(seen_parameters)} experiments already measured")

    op = OperatingPoints()
    op.add_range("nprobe", sorted(cfg.search.nprobe))
    if len(cfg.search.quantizer_efSearch) > 0:
        # drives the HNSW quantizer; the exact probe ignores it
        op.add_range("quantizer_efSearch", sorted(cfg.search.quantizer_efSearch))
    op.add_range("nshort", sorted(cfg.search.nshort))
    op.add_range("nmid_short", sorted(cfg.search.nmid_short) if mid_reranker is not None else [0])
    experiments = sort_experiments_by_prior(op, op.all_keys())
    log(f"Total experiments {op.num_experiments()}, running {len(experiments)}")

    def run_pipeline(parameters, exp_timers):
        """One operating point: coarse -> [mid-rerank] -> decode -> rerank."""
        nprobe = parameters["nprobe"]
        if index.hnsw is not None and "quantizer_efSearch" in parameters:
            index.ef_search = parameters["quantizer_efSearch"]
        nshort = parameters["nshort"]
        n_short_ivf = min(max(parameters["nmid_short"] * nshort, nshort), 8000)

        with exp_timers.search:
            _, I, codes = index.search_and_return_codes(xq, n_short_ivf, nprobe=nprobe,
                                                        nthreads=cfg.search.nthreads)
        codes_int32 = codes.reshape(n_short_ivf * nq, index.M + 1)
        codes_int32[:, 0] = np.clip(codes_int32[:, 0], 0, index.nlist - 1)
        if index.M * 2 == M and index.K == cfg.K ** 2:
            # a code-paired index: the decoders take the K-ary codes
            from .index_build import unpair_codes_ivf

            codes_int32 = unpair_codes_ivf(codes_int32, cfg.K)
        if codes_int32.shape[1] != M + 1:
            raise ValueError(f"index codes of width {codes_int32.shape[1]}, model M={M}")

        if nshort < n_short_ivf and mid_reranker is not None:
            with exp_timers.mid_rerank:
                D_ref = mid_reranker.scores(xq, codes_int32, index.ivf_centroids, n_short_ivf,
                                            nthreads=cfg.search.nthreads)
                idx = np.argsort(D_ref, axis=1)
                codes_int32 = np.take_along_axis(
                    codes_int32.reshape(nq, n_short_ivf, M + 1), idx[:, :nshort, None],
                    axis=1).reshape(nq * nshort, M + 1)
                I = np.take_along_axis(I, idx[:, :nshort], axis=1)

        ns = len(codes_int32) // nq
        topk = min(100, ns)
        with exp_timers.decode:
            idx = _fused_shortlist_topk(params, spec, codes_int32, xq, topk,
                                        q_block=min(nq, max(1, DECODE_BLOCK_ROWS // ns)))
        with exp_timers.rerank:
            I_refined = np.take_along_axis(I, idx, axis=1)
        return compute_recalls(I_refined, gt), compute_recalls(I, gt)

    explorer = AdaptiveExplorer(op, op.all_keys())
    n_total = len(experiments)
    i_exp = 0
    while True:
        key = explorer.next()
        if key is None:
            break
        parameters = op.get_parameters(key)
        i_exp += 1
        log(f"-\nExperiment {i_exp}/{n_total} {key}")

        if parameters in seen_parameters:
            for result in ivf_real_res:
                if result["key"] == list(key):
                    op.add_operating_point(key, result["recalls"]["1"], result["t_total"])
                    explorer.update(parameters, result["recalls"]["1"], result["t_total"])
                    break
            log("Loaded from previous checkpoint")
            continue
        seen_parameters.append(parameters)

        max_perf, min_time = op.predict_bounds(key)
        if not cfg.search.explore_all and not op.is_pareto_optimal(max_perf, min_time):
            log(f"SKIP, {max_perf=:.3f} {min_time=:.3f}")
            continue

        if cfg.search.get("warmup", True):
            # an untimed pass at the same shapes: first touches, allocator
            # growth and the native threads are not charged to the point
            run_pipeline(parameters, TimersManager("search", "mid_rerank", "decode", "rerank"))

        exp_timers = TimersManager("search", "mid_rerank", "decode", "rerank")
        recalls, recalls_orig = run_pipeline(parameters, exp_timers)
        total_time = exp_timers.sum().get()
        explorer.update(parameters, recalls[1], total_time)
        log(f"Achieved R@1={recalls[1] * 100:.2f} R@10={recalls[10] * 100:.2f} "
            f"R@100={recalls[100] * 100:.2f} in {exp_timers.sum().s()}")
        log(f"Timers: search={exp_timers.search.s()} + "
            f"mid_rerank={exp_timers.mid_rerank.s()} + "
            f"decode={exp_timers.decode.s()} + rerank={exp_timers.rerank.s()}")
        op.add_operating_point(key, recalls[1], total_time)
        ivf_real_res.append(dict(
            parameters=parameters, t_search=exp_timers.search.get(),
            t_mid_rerank=exp_timers.mid_rerank.get(), t_decode=exp_timers.decode.get(),
            t_rerank=exp_timers.rerank.get(), t_total=total_time,
            recalls={str(k): v for k, v in recalls.items()},
            recalls_orig={str(k): v for k, v in recalls_orig.items()},
            key=list(map(int, key))))
        if cfg.output:
            with open(cfg.output, "w") as sf:
                json.dump(json_results, sf)
    return json_results
