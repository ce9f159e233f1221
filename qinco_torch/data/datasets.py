"""Host-side data feeding for memory-mapped vector datasets
(counterpart of ``qinco_tpu/data/datasets.py``; the same batches in the
same order for the same seed).

- Batches are always exactly ``batch`` rows; the final partial batch is
  zero-padded and comes with its valid-row count, so the device sees one
  batch shape and the padding mask says which rows count.
- Blocks of up to 2M rows are read sequentially and shuffled within the
  block by ``np.random.default_rng(seed + epoch * 0x9E3779B9)``.
- Epoch ``e`` of a looped trainset covers rows ``[e·loop, (e+1)·loop)
  mod N``.
- ``shard=(i, n)`` gives data group ``i`` of ``n`` the contiguous span
  ``i`` of each epoch's rows, every span of one length (the remainder
  goes unread), so every rank runs the same number of batches and the
  collectives stay in lockstep.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .vecs_io import open_vectors

BLOCK_CACHE_ROWS = 2_000_000


@dataclass
class Batch:
    x: np.ndarray  # (batch, D) float32, zero-padded past n_valid
    n_valid: int


class BlockShuffledLoader:
    """Iterates fixed-size float32 batches over a (memmapped) row source."""

    def __init__(
        self,
        data: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = False,
        loop: int | None = None,
        block_rows: int = BLOCK_CACHE_ROWS,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
    ):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.block_rows = block_rows
        self.seed = seed
        self.shard_i, self.shard_n = shard
        n = len(data)
        self.loop = min(loop, n) if loop else None
        self.window = self.loop if self.loop else n
        self.n_total = n

    def __len__(self) -> int:
        per_shard = self.window // self.shard_n if self.shard_n > 1 else self.window
        return math.ceil(per_shard / self.batch_size)

    def _epoch_bounds(self, epoch: int) -> tuple[int, int]:
        """Row range [start, start+window) for this epoch's loop window."""
        if self.loop is None or self.window >= self.n_total:
            return 0, self.window
        start = (epoch * self.loop) % self.n_total
        return start, start + self.window

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        start, end = self._epoch_bounds(epoch)
        if self.shard_n > 1:  # this shard's contiguous span
            per = (end - start) // self.shard_n
            lo = start + per * self.shard_i
            hi = start + per * (self.shard_i + 1) if self.shard_i < self.shard_n - 1 else end
            hi = min(hi, lo + per) if per else hi  # one length on every shard
            start, end = lo, hi
        rng = np.random.default_rng(self.seed + epoch * 0x9E3779B9) if self.shuffle else None
        bs = self.batch_size
        leftover: np.ndarray | None = None

        for blk_start in range(start, end, self.block_rows):
            blk_end = min(end, blk_start + self.block_rows)
            lo = blk_start % self.n_total
            span = blk_end - blk_start
            if lo + span > self.n_total:  # window wraps around the dataset end
                block = np.concatenate(
                    [self.data[lo:], self.data[: lo + span - self.n_total]], axis=0)
            else:
                block = self.data[lo : lo + span]
            block = np.asarray(block, dtype=np.float32)
            if rng is not None:
                block = block[rng.permutation(len(block))]
            if leftover is not None and len(leftover):
                block = np.concatenate([leftover, block], axis=0)
                leftover = None
            n_full = (len(block) // bs) * bs
            for i in range(0, n_full, bs):
                yield Batch(block[i : i + bs], bs)
            if n_full < len(block):
                leftover = block[n_full:]

        if leftover is not None and len(leftover):
            n_valid = len(leftover)
            pad = np.zeros((bs - n_valid, leftover.shape[-1]), dtype=np.float32)
            yield Batch(np.concatenate([leftover, pad], axis=0), n_valid)

    def __iter__(self) -> Iterator[Batch]:
        return self.epoch(0)


def load_vec_trainset(cfg, shard: tuple[int, int] = (0, 1)):
    """Training/validation split and loaders: the last ``cfg.ds.valset``
    rows are the validation set, the (optionally capped) head the
    training set.  The loaders read data group ``shard``'s rows; the
    returned arrays are all the rows."""
    if cfg.trainset is None:
        raise ValueError("Provide a training dataset via 'trainset', or a default dataset "
                         "via 'db'")
    xt_full = open_vectors(cfg.trainset, "training")
    if cfg.ds.valset > len(xt_full) // 2:
        raise ValueError("Validation set larger than half the training set; abnormal "
                         "configuration")
    xt, xval = xt_full[: -cfg.ds.valset], xt_full[-cfg.ds.valset :]
    cfg.ds.trainset = min(cfg.ds.trainset or len(xt), len(xt))
    xt = xt[: cfg.ds.trainset]

    loop = None if cfg.qinco1_mode else cfg.ds.loop
    train_loader = BlockShuffledLoader(xt, cfg.batch, shuffle=True, loop=loop, seed=cfg.seed,
                                       shard=shard)
    val_loader = BlockShuffledLoader(xval, cfg.batch, shuffle=False, shard=shard)
    return (xt, xval), (train_loader, val_loader)


def load_vec_db(cfg, shard: tuple[int, int] = (0, 1)):
    """The database rows ``[:cfg.ds.db]`` and their loader over data
    group ``shard``'s rows."""
    if cfg.db is None:
        raise ValueError("Provide a database path or preset name via 'db'")
    xdb = open_vectors(cfg.db, "database")
    cfg.ds.db = min(cfg.ds.db or len(xdb), len(xdb))
    xdb = xdb[: cfg.ds.db]
    return xdb, BlockShuffledLoader(xdb, cfg.batch, shuffle=False, shard=shard)


def load_queries_data(cfg):
    """The query vectors and their ground-truth neighbour ids."""
    if cfg.queries is None:
        raise ValueError("Provide queries via 'queries'")
    if cfg.queries_gt is None:
        raise ValueError("Provide ground truth via 'queries_gt'")
    return open_vectors(cfg.queries, "queries"), open_vectors(cfg.queries_gt, "queries_gt")
