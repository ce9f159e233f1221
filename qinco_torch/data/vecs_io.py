"""Memory-mapped readers for the classic ANN vector file formats
(counterpart of ``qinco_tpu/data/vecs_io.py``): each vector is
``[int32 dim][dim × elem]`` with elem uint8 (.bvecs), float32 (.fvecs) or
int32 (.ivecs); ``.npy`` files are memory-mapped as they are.  The
writers give the same bytes as the JAX package's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _xvecs_mmap(fname: str | Path, dtype, elem_size: int) -> np.ndarray:
    fname = Path(fname)
    size = fname.stat().st_size
    with open(fname, "rb") as f:
        dim = int(np.fromfile(f, dtype=np.int32, count=1)[0])
    if not 0 < dim < 10**6:
        raise ValueError(f"implausible vector dim {dim} in {fname}")
    row_bytes = 4 + dim * elem_size
    if size % row_bytes:
        raise ValueError(f"{fname}: size {size} not a multiple of {row_bytes}")
    n = size // row_bytes
    if elem_size == 4:
        mm = np.memmap(fname, dtype=np.int32, mode="r", shape=(n, dim + 1))
        return mm[:, 1:].view(dtype)
    # uint8 payload with int32 header: map as bytes and slice off the header
    mm = np.memmap(fname, dtype=np.uint8, mode="r", shape=(n, row_bytes))
    return mm[:, 4:]


def bvecs_mmap(fname: str | Path) -> np.ndarray:
    return _xvecs_mmap(fname, np.uint8, 1)


def fvecs_mmap(fname: str | Path) -> np.ndarray:
    return _xvecs_mmap(fname, np.float32, 4)


def ivecs_mmap(fname: str | Path) -> np.ndarray:
    return _xvecs_mmap(fname, np.int32, 4)


def _xvecs_write(fname: str | Path, x: np.ndarray, dtype) -> None:
    x = np.ascontiguousarray(np.asarray(x).astype(dtype))
    n, d = x.shape
    header = np.full((n, 1), d, dtype=np.int32)
    if dtype == np.uint8:
        out = np.concatenate([header.view(np.uint8).reshape(n, 4), x], axis=1)
    else:
        out = np.concatenate([header, x.view(np.int32)], axis=1)
    with open(fname, "wb") as f:
        out.tofile(f)


def fvecs_write(fname: str | Path, x: np.ndarray) -> None:
    _xvecs_write(fname, x, np.float32)


def ivecs_write(fname: str | Path, x: np.ndarray) -> None:
    _xvecs_write(fname, x, np.int32)


def bvecs_write(fname: str | Path, x: np.ndarray) -> None:
    _xvecs_write(fname, x, np.uint8)


def open_vectors(filepath: str | Path, dataname: str = "data") -> np.ndarray:
    """Open any supported vector file as a (possibly memmapped) 2-D array."""
    p_file = Path(filepath) if filepath else None
    if p_file is None or not p_file.is_file():
        raise FileNotFoundError(f"File {filepath} for data source {dataname} doesn't exist")
    readers = {".bvecs": bvecs_mmap, ".fvecs": fvecs_mmap, ".ivecs": ivecs_mmap,
               ".npy": lambda p: np.load(p, mmap_mode="r")}
    if p_file.suffix not in readers:
        raise ValueError(f"Unsupported format {p_file.suffix!r} for {dataname} at {filepath}. "
                         "Supported: npy, bvecs, fvecs, ivecs.")
    return readers[p_file.suffix](p_file)
