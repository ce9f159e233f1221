"""A segment sum that gives the same bits on every run, and the row gather
whose gradient goes through it.

On a CUDA device ``index_add_``, ``index_put_(accumulate=True)`` and the
backward of ``table[ids]`` sum by atomic adds, in whatever order the
threads arrive: two runs of one program differ in the last bits, and a
k-means assignment, a greedy argmin or a training run can then go
another way.  (The JAX package's ``jax.ops.segment_sum`` is
deterministic on a TPU.)  :func:`segment_sum` sorts the rows by segment
(a stable sort) and sums each segment's rows in that order
(``torch.segment_reduce``: one thread a segment and column, no atomics),
the same on the CPU and on the card.  It reads nothing back to the host.
"""

from __future__ import annotations

import torch


def segment_offsets(ids: torch.Tensor, num_segments: int):
    """``(order, offsets)``: the stable order that sorts ``ids`` and the
    ``num_segments + 1`` offsets of each segment in that order."""
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    bounds = torch.arange(num_segments + 1, device=ids.device, dtype=sorted_ids.dtype)
    return order, torch.searchsorted(sorted_ids, bounds)


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = sum(values[i] for i where ids[i] == s)`` in float32, for
    ``values (n, ...)`` and integer ``ids (n,)`` in ``[0, num_segments)``:
    the rows of a segment are added in their order in ``values``.  An
    empty segment sums to 0."""
    if values.shape[0] != ids.shape[0]:
        raise ValueError(f"values {tuple(values.shape)} and ids {tuple(ids.shape)} differ in rows")
    order, offsets = segment_offsets(ids, num_segments)
    return torch.segment_reduce(values.float()[order], "sum", offsets=offsets, axis=0,
                                unsafe=True)


def segment_counts(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows per segment, ``(num_segments,)`` int64, with nothing read back
    to the host (``bincount`` on the card reads the largest id first)."""
    _, offsets = segment_offsets(ids, num_segments)
    return offsets[1:] - offsets[:-1]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        g = segment_sum(grad.reshape(ids.numel(), *grad.shape[ids.dim():]), ids.reshape(-1),
                        ctx.num_rows)
        return g.to(grad.dtype), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for an integer ``ids``, whose gradient with respect
    to ``table`` is :func:`segment_sum` of the incoming gradient (plain
    autograd sums it by atomic adds on the card)."""
    ids = ids.long()
    if not table.requires_grad or not torch.is_grad_enabled():
        return table[ids]
    return _GatherRows.apply(table, ids)
