from .vecs_io import (
    bvecs_mmap,
    bvecs_write,
    fvecs_mmap,
    fvecs_write,
    ivecs_mmap,
    ivecs_write,
    open_vectors,
)
from .datasets import (
    Batch,
    BlockShuffledLoader,
    load_queries_data,
    load_vec_db,
    load_vec_trainset,
)

__all__ = [
    "bvecs_mmap",
    "fvecs_mmap",
    "ivecs_mmap",
    "bvecs_write",
    "fvecs_write",
    "ivecs_write",
    "open_vectors",
    "Batch",
    "BlockShuffledLoader",
    "load_vec_trainset",
    "load_vec_db",
    "load_queries_data",
]
