"""The IVF book sharded over the ranks of a model group (counterpart of
``qinco_tpu/parallel/sharded_ops.py``).

The 2^20-entry IVF book (0.5 GB at D=128, 3 GB at D=768) is the one tensor
of QINCo that may be worth splitting across cards.  Each rank of a model
group keeps the rows ``[m·K/n, (m+1)·K/n)`` of its model index ``m``,
scans only those, and the ranks merge their ``(nq, k)`` candidates with
one all-gather over the group; the book never moves.

Ties: each shard's candidates come sorted by a stable sort (lowest id
first), the shards are gathered in rank order, and the final top-k is a
stable sort too, so equal distances fall to the lower global id, as
``lax.top_k`` orders them.
"""

from __future__ import annotations

import torch

from ..ops.distances import chunked_argmin, pairwise_sqdist, pairwise_sqdist_partial
from ..ops.distances import topk_smallest
from .mesh import Mesh, all_gather_cat, all_reduce_sum

# Elements of the live (queries, shard rows) distance tile.
TILE_ELEMS = 2**28


def shard_codebook(mesh: Mesh, book: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a ``(K, D)`` book: block ``model_rank`` of
    ``model_size`` (a copy, so the full book can be freed)."""
    K, n = book.shape[0], mesh.model_size
    if K % n:
        raise ValueError(f"a book of {K} rows does not split into mesh.model={n} shards")
    rows = K // n
    return book[mesh.model_rank * rows:(mesh.model_rank + 1) * rows].clone()


def sharded_coarse_topk(mesh: Mesh, xq: torch.Tensor, shard: torch.Tensor, k: int, *,
                        exact: bool = True):
    """Top-k nearest book rows of ``xq (nq, D)`` (the same on every rank of
    the model group) with the book sharded over the group: each rank's
    local top-k (offset into the global book), one all-gather of ids and
    one of distances, and a stable top-k over the ``shards x k``
    candidates.  Returns ``(ids (nq, k) int64, distances (nq, k))``: exact
    squared distances with ``exact``, else partial (rank-only) ones."""
    rows = shard.shape[0]
    k_local = min(k, rows)
    dist_fn = pairwise_sqdist if exact else pairwise_sqdist_partial
    block = max(1, TILE_ELEMS // rows)
    ids, dists = [], []
    for q0 in range(0, xq.shape[0], block):
        i, d = topk_smallest(dist_fn(xq[q0:q0 + block], shard), k_local)
        ids.append(i)
        dists.append(d)
    ids = torch.cat(ids) + mesh.model_rank * rows
    all_i = all_gather_cat(mesh, ids, dim=1)
    all_d = all_gather_cat(mesh, torch.cat(dists), dim=1)
    sel, d = topk_smallest(all_d, k)
    return torch.gather(all_i, 1, sel), d


def sharded_ivf_assign(mesh: Mesh, x: torch.Tensor, shard: torch.Tensor, *,
                       chunk: int = 65536) -> torch.Tensor:
    """Nearest-centroid ids ``(N,)`` int64 with a sharded IVF book: the
    top-1 of :func:`sharded_coarse_topk` on partial distances, each shard
    scanned by ``chunked_argmin`` (its first minimum), then the first
    minimum over the shards in rank order.  The counterpart of the
    replicated ``chunked_argmin``."""
    rows = shard.shape[0]
    ids, d = chunked_argmin(x, shard, chunk=chunk)
    ids = ids + mesh.model_rank * rows
    all_i = all_gather_cat(mesh, ids[:, None], dim=1)
    all_d = all_gather_cat(mesh, d[:, None], dim=1)
    best = torch.argmin(all_d, dim=1, keepdim=True)  # the first minimum
    return torch.gather(all_i, 1, best)[:, 0]


@torch.no_grad()
def encode_ivf_sharded(mesh: Mesh, params, spec, x: torch.Tensor):
    """Beam-search encode of ``x (N, D)`` (normalized space) with
    ``params.codebook0`` holding this rank's shard of the IVF book (see
    :func:`shard_codebook`): step 0 by :func:`sharded_ivf_assign`; its
    reconstruction filled by the rank that owns each row, zeros elsewhere,
    then summed over the model group (exact: ``v + 0 = v``); then the MLP
    steps of ``encode_from_coarse``.  Returns ``(codes, xhat, stats)`` as
    ``encode`` does; every rank of the model group must call it on the
    same ``x``."""
    from ..models.qinco import encode_from_coarse

    assert spec.ivf_in_use, "the sharded step 0 needs an IVF model"
    x = x.float()
    shard = params.codebook0
    rows = shard.shape[0]
    codes0 = sharded_ivf_assign(mesh, x, shard)
    local = codes0 - mesh.model_rank * rows
    own = (local >= 0) & (local < rows)
    xhat0 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    xhat0[own] = shard[local[own]].float()
    all_reduce_sum(mesh, [xhat0], axis="model")
    return encode_from_coarse(params, spec, x, codes0[:, None], xhat0[:, None, :])
