"""Pairwise additive decoder for the mid-rerank (counterpart of
``qinco_tpu/search/pairwise_decoder.py``; QINCo2 paper §3.3):

1. the IVF book is decomposed into ``IVF_M = 5`` small K-entry books by
   usage-weighted k-means over the centroids themselves, giving every IVF
   code a 5-tuple of small codes;
2. ``M_target = n_pairwise_codebooks · M`` code pairs (m1, m2) are chosen
   greedily: for each candidate pair a K²-entry book of conditional means
   of the current residual is fitted, the pair with the lowest error on the
   first ``EVAL_ROWS`` rows is kept and its reconstruction subtracted;
3. decoding is ``Σ_t books[t][c_{m1(t)} · K + c_{m2(t)}]``.

Every fit sums through :func:`~qinco_torch.ops.segment.segment_sum`, so
the greedy argmin over errors sees the same bits on every run (on the
card too) and picks the same pairs.  A decoder decodes and scores on its
``device``: on the CPU with the native library's ``qpw_decode`` /
``qpw_score``, on the card with torch gathers on books held there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.distances import pairwise_sqdist_partial
from ..ops.segment import segment_counts, segment_sum
from ..utils import resolve_device

IVF_M = 5
ITER_STEPS = 50
EVAL_ROWS = 100_000


# ---------------------------------------------------------------------------
# IVF codebook decomposition
# ---------------------------------------------------------------------------


def _weighted_kmeans_step(centroids, weights, book, K_base):
    assign = torch.argmin(pairwise_sqdist_partial(centroids, book), dim=-1)
    sums = segment_sum(centroids * weights[:, None], assign, K_base)
    counts = segment_sum(weights[:, None], assign, K_base)[:, 0]
    return assign, sums / torch.clamp(counts, min=1.0)[:, None]


def decompose_ivf_codebook(ivf_centroids: np.ndarray, usage_counts: np.ndarray, K_base: int, *,
                           ivf_m: int = IVF_M, iters: int = ITER_STEPS, seed: int = 0,
                           device=None):
    """-> ``(small_books (ivf_m, K_base, D), code_map (IVF_K, ivf_m) int64)``:
    stage-wise k-means on the residual IVF centroids, weighted by usage,
    initialized by a draw of ``np.random.default_rng(seed)`` (the JAX
    package's draw) and stopped when the assignment no longer moves."""
    device = resolve_device(device)
    cent = torch.as_tensor(np.asarray(ivf_centroids, np.float32), device=device)
    weights_np = np.maximum(usage_counts, 0).astype(np.float32)
    weights = torch.as_tensor(weights_np, device=device)
    IVF_K = cent.shape[0]
    rng = np.random.default_rng(seed)
    probs = weights_np.astype(np.float64)
    books, maps = [], []
    for _ in range(ivf_m):
        p = probs / probs.sum() if probs.sum() > 0 else None
        init_idx = rng.choice(IVF_K, size=K_base, replace=False, p=p)
        book = cent[torch.as_tensor(init_idx, device=device)]
        assign = torch.zeros((IVF_K,), dtype=torch.int64, device=device)
        for it in range(iters):
            new_assign, book = _weighted_kmeans_step(cent, weights, book, K_base)
            if it > 0 and bool(torch.equal(new_assign, assign)):
                break
            assign = new_assign
        books.append(book.cpu().numpy())
        maps.append(assign.cpu().numpy())
        cent = cent - book[assign]
    return np.stack(books), np.stack(maps, axis=1)


# ---------------------------------------------------------------------------
# Greedy pairwise codebook training
# ---------------------------------------------------------------------------


def _fit_pair_book(comb: torch.Tensor, resid: torch.Tensor, K2: int, shrink: float = 0.0):
    """Conditional mean of ``resid`` per combined code, with ``shrink``
    pseudo-counts per bin pulling sparse bins toward zero."""
    counts = segment_counts(comb, K2).float()
    sums = segment_sum(resid, comb, K2)
    return sums / torch.clamp(counts + shrink, min=1.0)[:, None]


def _pair_error(comb, resid, K2, n_eval, shrink=0.0) -> torch.Tensor:
    book = _fit_pair_book(comb, resid, K2, shrink)
    r = resid[:n_eval] - book[comb[:n_eval]]
    return (r * r).sum() / n_eval


@dataclass
class PairwiseDecoder:
    """A trained pairwise decoder and the device it decodes on (the npz
    holds the weights only)."""

    books: np.ndarray  # (M_target, K_base**2, D)
    pairs: np.ndarray  # (2, M_target) rows of the combined codes
    ivf_small_books: np.ndarray  # (IVF_M, K_base, D)
    ivf_code_map: np.ndarray  # (IVF_K, IVF_M)
    K_base: int
    M_base: int
    device: torch.device = field(default=None, compare=False)
    _dev: tuple | None = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def save(self, path) -> None:
        """The JAX package's npz, uncompressed: the K²-entry books (512 MB
        at K = 256, M = 8) barely compress and zlib takes tens of seconds
        over them."""
        np.savez(path, books=self.books, pairs=self.pairs, ivf_small_books=self.ivf_small_books,
                 ivf_code_map=self.ivf_code_map, K_base=self.K_base, M_base=self.M_base)

    @classmethod
    def load(cls, path, device=None) -> "PairwiseDecoder":
        z = np.load(path)
        return cls(books=z["books"], pairs=z["pairs"], ivf_small_books=z["ivf_small_books"],
                   ivf_code_map=z["ivf_code_map"], K_base=int(z["K_base"]),
                   M_base=int(z["M_base"]), device=device)

    def _device_tables(self):
        """The books, pairs and code map on the device, moved there once
        (the K²-entry books are hundreds of MB)."""
        if self._dev is None:
            self._dev = (torch.as_tensor(np.asarray(self.books, np.float32), device=self.device),
                         torch.as_tensor(np.asarray(self.pairs), device=self.device).long(),
                         torch.as_tensor(np.asarray(self.ivf_code_map),
                                         device=self.device).long())
        return self._dev

    def _native_args(self):
        return (np.ascontiguousarray(self.books, np.float32),
                np.ascontiguousarray(self.ivf_code_map, np.int32),
                np.ascontiguousarray(self.pairs, np.int32))

    def decode(self, codes_MB: np.ndarray, ivf_codes: np.ndarray) -> np.ndarray:
        """Residual reconstruction past the IVF centroid of ``codes_MB
        (M_base, B)`` and ``ivf_codes (B,)`` -> ``(B, D)``: the native
        kernel on the CPU, torch gathers on the card."""
        if self.device.type == "cpu":
            return self.decode_native(codes_MB, ivf_codes)
        books, pairs, code_map = self._device_tables()
        out = pairwise_decode(books, pairs, code_map,
                              torch.as_tensor(np.asarray(codes_MB), device=self.device).long(),
                              torch.as_tensor(np.asarray(ivf_codes), device=self.device).long(),
                              self.K_base)
        return out.cpu().numpy()

    def decode_native(self, codes_MB: np.ndarray, ivf_codes: np.ndarray,
                      nthreads: int = 0) -> np.ndarray:
        """The native ``qpw_decode``: the same table sum in the same order."""
        import ctypes

        from .index import _ptr, get_lib

        codes_MB = np.ascontiguousarray(codes_MB, np.int32)
        ivf_codes = np.ascontiguousarray(ivf_codes, np.int32)
        books, code_map, pairs = self._native_args()
        T, K2, D = books.shape
        B = codes_MB.shape[1]
        out = np.empty((B, D), np.float32)
        get_lib().qpw_decode(
            _ptr(books, ctypes.c_float), _ptr(codes_MB, ctypes.c_int),
            _ptr(ivf_codes, ctypes.c_int), _ptr(code_map, ctypes.c_int), code_map.shape[1],
            self.M_base, self.K_base, _ptr(pairs, ctypes.c_int), T, B, K2, D,
            _ptr(out, ctypes.c_float), nthreads)
        return out

    def scores(self, xq: np.ndarray, codes_int32: np.ndarray, centroids, nmid: int,
               nthreads: int = 0) -> np.ndarray:
        """Mid-rerank scores ``(nq, nmid)``: the squared distance of each
        query to the decoded reconstruction (centroid + residual) of its
        ``nmid`` shortlist entries, ``codes_int32 (nq·nmid, M_base + 1)``
        with the IVF code in column 0.  The decoded shortlist is never
        returned.  On the CPU the native ``qpw_score``; on the card torch,
        with ``centroids`` a host array or a tensor there."""
        nq = len(xq)
        if self.device.type == "cpu":
            import ctypes

            from .index import _ptr, get_lib

            codes_int32 = np.ascontiguousarray(codes_int32, np.int32)
            xq = np.ascontiguousarray(xq, np.float32)
            cents = np.ascontiguousarray(
                centroids.cpu().numpy() if torch.is_tensor(centroids) else centroids,
                np.float32)
            books, code_map, pairs = self._native_args()
            T, K2, D = books.shape
            B = codes_int32.shape[0]
            if B != nq * nmid or codes_int32.shape[1] != self.M_base + 1:
                raise ValueError(f"codes {codes_int32.shape} for {nq} queries x {nmid}")
            out = np.empty((B,), np.float32)
            get_lib().qpw_score(
                _ptr(books, ctypes.c_float), _ptr(codes_int32, ctypes.c_int),
                _ptr(code_map, ctypes.c_int), code_map.shape[1], self.M_base, self.K_base,
                _ptr(pairs, ctypes.c_int), T, K2, D, _ptr(cents, ctypes.c_float),
                _ptr(xq, ctypes.c_float), nmid, B, _ptr(out, ctypes.c_float), nthreads)
            return out.reshape(nq, nmid)
        books, pairs, code_map = self._device_tables()
        codes = torch.as_tensor(np.asarray(codes_int32), device=self.device).long()
        return pairwise_scores(
            books, pairs, code_map, codes[:, 1:].T, codes[:, 0],
            torch.as_tensor(centroids, device=self.device),
            torch.as_tensor(np.asarray(xq, np.float32), device=self.device), self.K_base,
            nmid).cpu().numpy()


def pairwise_decode(books, pairs, ivf_code_map, codes_MB, ivf_codes, K_base):
    """codes_MB (M_base, B), ivf_codes (B,) -> xhat (B, D): the books
    summed in order from zeros, as the native kernel sums them."""
    ivf_small = ivf_code_map[ivf_codes].T  # (IVF_M, B)
    all_codes = torch.cat([codes_MB, ivf_small], dim=0)
    comb = all_codes[pairs[0]] * K_base + all_codes[pairs[1]]  # (M_target, B)
    out = torch.zeros((codes_MB.shape[1], books.shape[-1]), dtype=torch.float32,
                      device=books.device)
    for t in range(books.shape[0]):
        out += books[t][comb[t]]
    return out


def pairwise_scores(books, pairs, ivf_code_map, codes_MB, ivf_codes, centroids, xq, K_base,
                    nmid):
    """Mid-rerank scores (nq, nmid) on the device: decode, centroid add
    and squared distance."""
    xhat = pairwise_decode(books, pairs, ivf_code_map, codes_MB, ivf_codes, K_base)
    xhat = xhat + centroids[ivf_codes]
    q = torch.repeat_interleave(xq, nmid, dim=0)
    return ((q - xhat) ** 2).sum(-1).reshape(len(xq), nmid)


def train_pairwise_decoder(
    train_codes_MB: np.ndarray,  # (M_base, B) QINCo codes without the IVF row
    ivf_codes: np.ndarray,  # (B,)
    resid: np.ndarray,  # (B, D) training rows minus their IVF centroid
    ivf_centroids: np.ndarray,  # (IVF_K, D)
    *,
    K_base: int,
    M_target: int,
    seed: int = 0,
    shrinkage: float = 0.0,
    verbose: bool = True,
    log=print,
    device=None,
) -> PairwiseDecoder:
    """Decompose the IVF book, then choose ``M_target`` pairs greedily, on
    ``device``; the decoder it returns decodes there too."""
    device = resolve_device(device)
    B = resid.shape[0]
    M_base = train_codes_MB.shape[0]
    K2 = K_base * K_base

    usage = np.bincount(ivf_codes, minlength=len(ivf_centroids))
    ivf_small_books, ivf_code_map = decompose_ivf_codebook(ivf_centroids, usage, K_base,
                                                           seed=seed, device=device)
    all_codes = torch.as_tensor(np.concatenate(
        [np.asarray(train_codes_MB, np.int64), ivf_code_map[ivf_codes].T], axis=0),
        device=device)
    M_comb = M_base + IVF_M
    resid_t = torch.as_tensor(np.asarray(resid, np.float32), device=device)
    n_eval = min(EVAL_ROWS, B)

    pairs_all = [(m1, m2) for m1 in range(M_comb) for m2 in range(m1 + 1, M_comb)]
    books, sel_pairs = [], []
    for i_code in range(M_target):
        errs = torch.stack([
            _pair_error(all_codes[m1] * K_base + all_codes[m2], resid_t, K2, n_eval, shrinkage)
            for m1, m2 in pairs_all]).cpu().numpy()
        # the first of equal errors, as a strict < over the pairs in order picks it
        m1, m2 = pairs_all[int(np.argmin(errs))]
        comb = all_codes[m1] * K_base + all_codes[m2]
        book = _fit_pair_book(comb, resid_t, K2, shrinkage)
        resid_t = resid_t - book[comb]
        books.append(book.cpu().numpy())
        sel_pairs.append((m1, m2))
        if verbose:
            mse = float((resid_t ** 2).sum(-1).mean())
            log(f"pairwise code {i_code}: pair {m1}-{m2}, residual MSE={mse:g}")

    return PairwiseDecoder(books=np.stack(books), pairs=np.asarray(sel_pairs, np.int64).T,
                           ivf_small_books=ivf_small_books, ivf_code_map=ivf_code_map,
                           K_base=K_base, M_base=M_base, device=device)


def run_train_pairwise_decoder(task):
    """The ``train_pairwise_decoder`` task: train on the encoded training
    set, save the npz, and check its round trip on train and validation
    rows."""
    from ..metrics import corrected_mse
    from ..tasks.search_tasks import EncodedDBIterator

    cfg = task.cfg
    if not cfg.ivf_centroids or not cfg.encoded_trainset:
        raise ValueError("Specify 'ivf_centroids' and 'encoded_trainset'")
    if not (cfg.output and str(cfg.output).endswith(".npz")):
        raise ValueError("Specify a .npz output path")

    all_codes = EncodedDBIterator(cfg, cfg.encoded_trainset).load_all()  # (n, M_ivf)
    n_train = cfg.ds.trainset
    train_codes = all_codes[:n_train]
    val_codes = all_codes[-cfg.ds.valset:]

    ivf_centroids = task.ivf_centroids.astype(np.float32)
    train_vecs = np.asarray(task.train_vecs[:n_train], np.float32)
    val_vecs = np.asarray(task.val_vecs, np.float32)
    resid = train_vecs - ivf_centroids[train_codes[:, 0]]
    M_target = round(cfg.n_pairwise_codebooks * cfg.M)
    # 'auto' = pseudo-count 8, for bins that see a handful of rows each
    shrinkage = 8.0 if cfg.pairwise_shrinkage == "auto" else float(cfg.pairwise_shrinkage)

    dec = train_pairwise_decoder(
        train_codes[:, 1:].T, train_codes[:, 0], resid, ivf_centroids, K_base=cfg.K,
        M_target=M_target, seed=cfg.seed, shrinkage=shrinkage, verbose=cfg.verbose,
        log=task.print, device=task.device)
    dec.save(cfg.output)

    dec2 = PairwiseDecoder.load(cfg.output, device=task.device)
    rec = dec2.decode(train_codes[:65536, 1:].T, train_codes[:65536, 0])
    train_mse = corrected_mse(rec, resid[:65536], cfg.mse_scale)
    val_resid = val_vecs - ivf_centroids[val_codes[:, 0]]
    rec_val = dec2.decode(val_codes[:, 1:].T, val_codes[:, 0])
    val_mse = corrected_mse(rec_val, val_resid, cfg.mse_scale)
    task.print(f"pairwise decoder train_MSE={train_mse:.6f} val_MSE={val_mse:.6f}")
    return dec
