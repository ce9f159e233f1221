"""Bit-packed code files (counterpart of ``qinco_tpu/codec.py``; the same
bytes as the JAX package writes).

Codes ``(N, M)`` with K codewords a step pack into ``ceil(M·nbits/8)``
bytes a vector, ``nbits = max(1, ceil(log2 K))``, little-endian bit
order with code 0 at the lowest bits.  A file is the magic ``QCOD``, a
``<IIII`` header ``(N, M, K, nbits)`` and the packed rows.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

MAGIC = b"QCOD"


def pack_codes(codes: np.ndarray, nbits: int) -> np.ndarray:
    """codes (N, M) ints < 2^nbits -> packed (N, ceil(M*nbits/8)) uint8."""
    if not 1 <= nbits <= 32:
        raise ValueError(f"nbits must be in [1, 32], got {nbits}")
    codes = np.asarray(codes, np.uint64)
    n, m = codes.shape
    total_bits = m * nbits
    nbytes = (total_bits + 7) // 8
    shifts = np.arange(nbits, dtype=np.uint64)[None, None, :]
    bits = ((codes[:, :, None] >> shifts) & np.uint64(1)).reshape(n, -1)  # code 0 first
    padded = np.zeros((n, nbytes * 8), np.uint8)
    padded[:, :total_bits] = bits
    return (padded.reshape(n, nbytes, 8) << np.arange(8)[None, None, :]).sum(-1).astype(np.uint8)


def unpack_codes(packed: np.ndarray, m: int, nbits: int) -> np.ndarray:
    """packed (N, nbytes) uint8 -> codes (N, m) int32."""
    packed = np.asarray(packed, np.uint8)
    n = packed.shape[0]
    bitpos = np.arange(m * nbits)
    bits = (packed[:, bitpos // 8] >> (bitpos % 8)) & 1  # (n, m*nbits)
    bits = bits.reshape(n, m, nbits).astype(np.uint64)
    shifts = np.arange(nbits, dtype=np.uint64)[None, None, :]
    return (bits << shifts).sum(-1).astype(np.int32)


def write_codes_file(path: str | Path, codes: np.ndarray, K: int) -> None:
    """codes (M, N) or (N, M); stored row-per-vector with a header.  The
    layout is told by the shape: more columns than rows is (M, N), the
    layout ``encode`` returns."""
    codes = np.asarray(codes)
    if codes.shape[0] < codes.shape[1]:
        codes = codes.T
    n, m = codes.shape
    nbits = max(1, int(np.ceil(np.log2(K))))
    packed = pack_codes(codes, nbits)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IIII", n, m, K, nbits))
        packed.tofile(f)


def read_codes_file(path: str | Path) -> tuple[np.ndarray, int]:
    """-> (codes (N, M) int32, K)."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"not a packed codes file: {path}")
        n, m, K, nbits = struct.unpack("<IIII", f.read(16))
        nbytes = (m * nbits + 7) // 8
        packed = np.fromfile(f, dtype=np.uint8)
    if packed.size != n * nbytes:
        raise ValueError(f"{path}: {packed.size} bytes of codes, header says {n} x {nbytes}")
    return unpack_codes(packed.reshape(n, nbytes), m, nbits), K
