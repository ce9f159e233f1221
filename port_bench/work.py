"""Operations and bytes of the encode's kernels and of a training step,
worked out from shapes, and the H100's published peaks.

``PEAK_FLOPS``, ``PEAK_BYTES``, ``bound_ms``, ``_dims``, ``_ffn_flops``,
``_ffn_bytes``, ``selected_work``, ``_chain_flops``, ``_chain_bytes`` and
``rebuild_work`` are frozen copies of ``chip_smoke.py`` at commit 3513fb6
(nothing here imports it).  New here: ``PEAK_FLOPS["tf32"]``,
``ivf_work``, ``encode_launches``, ``encode_flops`` and ``train_flops``.
A ``spec`` is anything with the attributes ``D``, ``K``, ``De``, ``dh``,
``L`` and ``fast`` (``WorkSpec``).
"""

from __future__ import annotations

from typing import NamedTuple

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3;
# TF32 tensor cores (new here).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12


class WorkSpec(NamedTuple):
    D: int
    K: int
    De: int
    dh: int
    L: int
    fast: bool
    M: int
    A: int
    B: int
    ivf_K: int


def work_spec(cfg: dict) -> WorkSpec:
    """The sizes of a configuration file; ``fast`` as its encode profile sets it."""
    return WorkSpec(D=cfg["D"], K=cfg["K"], De=cfg["de"] or cfg["D"], dh=cfg["dh"], L=cfg["L"],
                    fast=cfg["encode_profile"] in ("parity", "speed"), M=cfg["M"], A=cfg["A"],
                    B=cfg["B"], ivf_K=cfg["ivf_K"])


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _dims(spec):
    return spec.D, spec.K, spec.De, spec.dh, spec.L


def _ffn_flops(spec, blocks):
    return blocks * 2 * (2 * spec.De * spec.dh)


def _ffn_bytes(spec, esize):
    D, K, De, Dh, L = _dims(spec)
    return 2 * L * De * Dh * esize + (De * D * esize if De != D else 0)


def selected_work(spec, N, F_in, A, esize, external=False):
    """FLOPs and bytes of the selected-scores function at these shapes:
    the substep distances over K (in-kernel top-A only), the condition
    product, and per slot the lean fetch times wfold (``spec.fast``; the
    folded table fetches that column), the FFN blocks, out_proj and the
    distance.  Bytes: x, xh, the packed external vals and the packed output
    once, the step's weights (and the table) once."""
    D, K, De, Dh, L = _dims(spec)
    NF = N * F_in
    per_slot = (2 * D * De if spec.fast else 0) + _ffn_flops(spec, L) + (
        2 * De * D if De != D else 0) + 3 * D
    flops = NF * ((0 if external else 2 * K * D) + 2 * D * De + A * per_slot)
    table = K * (D if spec.fast else D + De) * esize
    weights = (0 if external else K * D * 4) + table + D * De * esize * (2 if spec.fast else 1)
    nbytes = 4 * (N * D + NF * D + NF * A * (2 if external else 1)) + weights + _ffn_bytes(
        spec, esize)
    return flops, nbytes


def _chain_flops(spec, rank):
    """FLOPs of the unfolded step MLP for one pair (_mlp_chain)."""
    D, K, De, Dh, L = _dims(spec)
    concat = 2 * (De + D) * (rank or De) + (2 * rank * De if rank else 0)
    return (2 * D * De if De != D else 0) * 2 + concat + _ffn_flops(spec, L)


def _chain_bytes(spec, rank, esize):
    D, K, De, Dh, L = _dims(spec)
    concat = (De + D) * (rank or De) * esize + (rank * De * esize if rank else 0)
    return concat + _ffn_bytes(spec, esize) + (D * De * esize if De != D else 0)


def rebuild_work(spec, N, F_in, A, F_out, esize, rank=None):
    """FLOPs and bytes of select-rebuild: the MLP for N·F_out pairs (the
    selection's compares are not counted).  Bytes: dists, xh, the f32
    codebook and weights read once, xhat, codes and parents written once."""
    D, K = spec.D, spec.K
    flops = N * F_out * _chain_flops(spec, rank)
    nbytes = 4 * (N * F_in * A + N * F_in * D + K * D) + _chain_bytes(spec, rank, esize) + (
        4 * N * F_out * (D + 2))
    return flops, nbytes


def ivf_work(spec, N):
    """FLOPs and bytes of the IVF step 0 for N vectors: the product with
    the whole book, 2·N·ivf_K·D; x, the book and the codes counted once."""
    return 2 * N * spec.ivf_K * spec.D, 4 * (N * spec.D + spec.ivf_K * spec.D) + 8 * N


def encode_launches(spec):
    """(F_in, A) of each MLP step's B2 and B3 launch for one chunk: the
    first step out of the IVF step takes one beam row and max(A, B)
    candidates, the others B rows and A."""
    return [(1, max(spec.A, spec.B))] + [(spec.B, spec.A)] * (spec.M - 1)


def encode_flops(spec, N):
    """FLOPs of encoding N vectors: the IVF product, then each MLP step's
    selected scores and select-rebuild."""
    flops = ivf_work(spec, N)[0]
    for F_in, A in encode_launches(spec):
        flops += selected_work(spec, N, F_in, A, 2)[0] + rebuild_work(spec, N, F_in, A,
                                                                      spec.B, 2)[0]
    return flops


def train_flops(spec, N):
    """FLOPs of one training step on N rows: the encode, then the decode
    losses' forward (one MLP pass a row and step, and the substep
    distances) and backward (twice the forward's products)."""
    forward = N * spec.M * (_chain_flops(spec, None) + 6 * spec.D)
    return encode_flops(spec, N) + 3 * forward
