"""Two-stage flat search: an AQ look-up-table shortlist, then the QINCo
decode and exact rerank (counterpart of ``qinco_tpu/search/two_stage.py``;
the reference's ``qinco_v1/search_2stage.py``).

Stage 1 ranks the whole database by the fixed-codebook (AQ)
reconstruction distance without reconstructing it: one product builds a
query batch's look-up tables, and a gather over the stored codes adds
them up.  Stage 2 decodes the top ``nshort`` with the QINCo model and
keeps the exact top 100.  Everything runs on the parameters' device; the
top-k's are stable (the smaller index first on ties, ``lax.top_k``'s
order).
"""

from __future__ import annotations

import numpy as np
import torch

from ..metrics import compute_recalls
from ..models.qinco import decode_raw
from ..ops.distances import topk_smallest
from ..utils import TimersManager, host_to_device, sync


def _aq_shortlist(q: torch.Tensor, codes_MN: torch.Tensor, codebooks: torch.Tensor,
                  norms: torch.Tensor, nshort: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 ranking of one query batch ``q (Bq, D)``: the partial
    distance ``‖y‖² − 2 Σ_m q·C_m[code_m]`` (‖q‖² is constant), accumulated
    from the norms in order of m.  Returns (ids, distances), (Bq, nshort)."""
    M, K, D = codebooks.shape
    luts = (-2.0 * (q @ codebooks.reshape(M * K, D).T)).reshape(len(q), M, K)
    dists = norms[None, :].expand(len(q), -1).clone()
    for m in range(M):
        dists += luts[:, m, codes_MN[m]]
    return topk_smallest(dists, nshort)


@torch.no_grad()
def run_search_two_stage(
    params,
    spec,
    db_codes: np.ndarray,  # (M_ivf, N) QINCo codes of the database
    aq_codebooks: np.ndarray,  # (M_ivf, K, D) fixed codebooks
    queries: np.ndarray,
    gt: np.ndarray,
    *,
    nshort: int = 100,
    batch_queries: int = 256,
    decode_batch: int = 8192,
    log=print,
):
    """-> (I (nq, min(100, nshort)) int64, recalls dict)."""
    device = params.codebook0.device
    timers = TimersManager("shortlist", "rerank")
    M, N = db_codes.shape
    if aq_codebooks.shape[0] != M:
        raise ValueError(f"{aq_codebooks.shape[0]} AQ codebooks for {M} code rows")

    codes = torch.as_tensor(np.array(db_codes, np.int64), device=device)
    books = torch.as_tensor(np.asarray(aq_codebooks, np.float32), device=device)
    # the AQ reconstruction norms ‖y‖², in f32, the books added in order of m
    recon = books[0][codes[0]]
    for m in range(1, M):
        recon += books[m][codes[m]]
    norms = (recon * recon).sum(-1)
    del recon

    all_I = []
    for i in range(0, len(queries), batch_queries):
        q = host_to_device(queries[i:i + batch_queries], device)
        with timers.shortlist:
            idx, _ = _aq_shortlist(q, codes, books, norms, nshort)
            sync(device)
        with timers.rerank:
            cand = codes[:, idx.reshape(-1)]  # (M, Bq * nshort)
            dec = torch.cat([decode_raw(params, spec, cand[:, j:j + decode_batch])
                             for j in range(0, cand.shape[1], decode_batch)])
            dec = dec.reshape(len(q), idx.shape[1], -1)
            d = ((q[:, None, :] - dec) ** 2).sum(-1)
            order, _ = topk_smallest(d, 100)
            all_I.append(torch.gather(idx, 1, order).cpu())
    I = torch.cat(all_I).numpy()
    recalls = compute_recalls(I, np.asarray(gt))
    log(f"2-stage search: R@1={recalls[1] * 100:.2f} R@10={recalls[10] * 100:.2f} "
        f"R@100={recalls[100] * 100:.2f} "
        f"[T_shortlist={timers.shortlist.s()} T_rerank={timers.rerank.s()}]")
    return I, recalls
