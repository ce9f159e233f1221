"""Index construction: the AQ training phase and the adding phase
(counterpart of ``qinco_tpu/search/index_build.py``).  The AQ fits run on
the task's device; the norms and the lists are built on the host, in the
native index."""

from __future__ import annotations

import numpy as np

from ..metrics import corrected_mse
from ..ops.aq import (
    compute_fixed_aq_codebooks,
    compute_fixed_aq_codebooks_backfit,
    reconstruct_from_codebooks,
)
from ..utils import Timer
from .index import IvfIndex

ADD_BATCH = 1_000_000
#: Above this many one-hot design columns (M·K) the normal equations stop
#: fitting in memory and the backfit is used.
AQ_DENSE_FIT_MAX = 16384


def pair_codes_ivf(codes: np.ndarray, K: int) -> np.ndarray:
    """Combine code pairs (m, m + M/2) into one K²-ary code:
    ``(n, M + 1)`` with the IVF code in column 0 -> ``(n, M/2 + 1)``."""
    ivf, rest = codes[:, :1], codes[:, 1:]
    M = rest.shape[-1]
    if M % 2:
        raise ValueError(f"pair_codes needs an even M, got {M}")
    rest = rest.reshape(-1, 2, M // 2)
    return np.concatenate([ivf, rest[:, 0] * K + rest[:, 1]], axis=-1)


def unpair_codes_ivf(codes: np.ndarray, K: int) -> np.ndarray:
    """Inverse of :func:`pair_codes_ivf`: ``(n, M/2 + 1) -> (n, M + 1)``."""
    ivf, paired = codes[:, :1], codes[:, 1:]
    return np.concatenate([ivf, paired // K, paired % K], axis=-1)


def build_index_training_phase(cfg, ivf_centroids: np.ndarray, vec_data: np.ndarray,
                               encoded_data: np.ndarray, log=print,
                               aq_dense_fit_max: int = AQ_DENSE_FIT_MAX,
                               device=None) -> IvfIndex:
    """Fit AQ codebooks to the IVF residuals of ``vec_data`` and return
    an empty index with its norm quantizer trained.  Paired codes
    (``search.pair_codes``, K² ≤ 65536) use full-reconstruction norms and
    2-byte codes; an M·K above ``aq_dense_fit_max`` takes the backfit,
    centred on the composed unpaired fit under ``search.pair_prior``."""
    timer = Timer()
    K = cfg.K
    unpaired_data = None
    if cfg.search.pair_codes:
        if K * K > 65536:
            raise ValueError(f"pair_codes requires K² <= 65536 (got K={K}); use K <= 256")
        log(f"[{timer}] Pairing training codes: K {K} -> {K * K}")
        K = K * K
        unpaired_data = encoded_data
        encoded_data = pair_codes_ivf(encoded_data, cfg.K)
    norm_mode = "full" if K > 256 else "resid"
    with timer:
        if vec_data.dtype != np.float32:
            raise ValueError(f"vectors must be float32, got {vec_data.dtype}")
        max_nt = min(len(vec_data), cfg.search.aq_training_samples)
        log(f"[{timer}] Computing residuals on {max_nt}/{len(vec_data)} rows")
        xt_residuals = vec_data - ivf_centroids[encoded_data[:, 0]]

        M_codes = encoded_data.shape[1] - 1
        if M_codes * K > aq_dense_fit_max:
            prior = None
            if unpaired_data is not None and cfg.search.pair_prior:
                log(f"[{timer}] Fitting the unpaired AQ prior ({M_codes * 2}x{cfg.K})")
                unp = compute_fixed_aq_codebooks(xt_residuals[:max_nt],
                                                 unpaired_data[:max_nt, 1:], k=cfg.K,
                                                 device=device)
                half = unp.shape[0] // 2
                prior = (unp[:half, :, None, :] + unp[half:, None, :, :]).reshape(half, K, -1)
            log(f"[{timer}] Training fixed AQ codebooks (backfit, {M_codes}x{K}"
                + (", prior-centered shrinkage)" if prior is not None else ")"))
            codebooks = compute_fixed_aq_codebooks_backfit(
                xt_residuals[:max_nt], encoded_data[:max_nt, 1:], k=K, prior=prior,
                device=device)
        else:
            log(f"[{timer}] Training fixed AQ codebooks")
            codebooks = compute_fixed_aq_codebooks(xt_residuals[:max_nt],
                                                   encoded_data[:max_nt, 1:], k=K,
                                                   device=device)
        log(f"[{timer}] Codebooks {codebooks.shape}")

        xt_recons = reconstruct_from_codebooks(encoded_data[:, 1:], codebooks)
        mse = corrected_mse(xt_recons, xt_residuals, cfg.mse_scale)
        log(f"[{timer}] AQ train MSE: {mse:g}")

        index = IvfIndex.build(ivf_centroids, codebooks, norm_mode=norm_mode, device=device)
        if norm_mode == "full":
            norms = ((xt_recons + ivf_centroids[encoded_data[:, 0]]) ** 2).sum(-1)
            index.train_norm(norms, list_nos=encoded_data[:, 0])
        else:
            index.train_norm((xt_recons ** 2).sum(-1))
        log(f"[{timer}] Index ready (nlist={index.nlist}, M={index.M}, norm_mode={norm_mode})")
    return index


def build_index_adding_phase(cfg, encoded_db, index: IvfIndex, log=print) -> None:
    """Pack the encoded database's codes into the inverted lists,
    ``ADD_BATCH`` rows at a time."""
    timer = Timer()
    with timer:
        for batch in encoded_db.iter(ADD_BATCH):
            if cfg.search.pair_codes:
                batch = pair_codes_ivf(batch, cfg.K)
            if batch.shape[1] != index.M + 1:
                raise ValueError(f"codes of width {batch.shape[1]} for an index of M={index.M}")
            recons = reconstruct_from_codebooks(batch[:, 1:], index.codebooks)
            if index.norm_mode == "full":
                recons = recons + index.ivf_centroids[batch[:, 0]]
            norms = (recons ** 2).sum(-1)
            ids = np.arange(encoded_db.batch_start_id, encoded_db.batch_end_id, dtype=np.int64)
            log(f"[{timer}] Adding rows {encoded_db.batch_start_id}:{encoded_db.batch_end_id}")
            index.add_batch(ids, batch[:, 0], batch[:, 1:], norms)
    log(f"Adding done in {timer}; ntotal={index.ntotal}")


def run_build_index(task):
    """The ``build_index`` task: AQ fit on the encoded training set, then
    the encoded database into the lists, saved as ``.qivf``."""
    from ..data.datasets import load_vec_trainset
    from ..tasks.search_tasks import EncodedDBIterator

    cfg = task.cfg
    for key in ("ivf_centroids", "encoded_db", "encoded_trainset"):
        if not cfg.get(key):
            raise ValueError(f"Specify '{key}'")
    if not (cfg.output and str(cfg.output).endswith(".qivf")):
        raise ValueError("Specify a .qivf output path for the index")

    (train_vecs, _), _ = load_vec_trainset(cfg)
    train_codes = EncodedDBIterator(cfg, cfg.encoded_trainset).load_all()
    n = min(len(train_vecs), len(train_codes), cfg.ds.trainset or len(train_vecs))
    encoded_db = EncodedDBIterator(cfg, cfg.encoded_db)
    index = build_index_training_phase(
        cfg, task.ivf_centroids.astype(np.float32), np.asarray(train_vecs[:n], np.float32),
        train_codes[:n], log=task.print, device=task.device)
    build_index_adding_phase(cfg, encoded_db, index, log=task.print)
    task.print(f"Saving index to {cfg.output}")
    index.save(cfg.output)
    return index
