"""ctypes binding for the native IVF index (``native/ivf_index.cpp``,
``native/hnsw.cpp``), and the coarse probe and LUTs on the device
(counterpart of ``qinco_tpu/search/index.py``).

The C++ side owns the inverted lists and their scan; the coarse probe
(the exact top-nprobe over the IVF book) and the look-up tables are
matrix products that run with torch on the index's device.  The port
builds its own copy of the native library, from the repository's
``native/`` sources, at first use into ``build/qinco_torch_native/``,
under a name keyed by the sources and the host: ``-march=native`` makes a library built on another
host unsafe to load, so none is.  The library needs OpenMP; a failed
build raises.  The files it writes (``.qivf`` and its ``.meta.npz``) are the
JAX package's.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops.distances import pairwise_sqdist_partial
from ..utils import resolve_device

_NATIVE_SRC = Path(__file__).resolve().parent.parent.parent / "native"
# where the port builds its copy of the library
_NATIVE_BUILD = _NATIVE_SRC.parent / "build" / "qinco_torch_native"
# Padding distance of the probe's last chunk: large and finite, since an
# inf would give 0 * inf = NaN in the product form of the distance.
PAD_DIST = 3.4e37


def native_cxx() -> str:
    """The C++ compiler of the native build: ``$QINCO_TORCH_CXX``, else the
    ``g++`` on the PATH.  ``$CXX`` is not read: it may name a compiler set
    up as CUDA's host compiler, without the OpenMP the scan needs."""
    return os.environ.get("QINCO_TORCH_CXX") or shutil.which("g++") or "g++"


def native_lib_path() -> Path:
    """The library's file: its name carries a hash of the sources, the
    Makefile and the host's name and machine, so that a library built from
    other sources or on another host (``-march=native``) is never loaded."""
    h = hashlib.sha256()
    for src in sorted(_NATIVE_SRC.glob("*.cpp")) + [_NATIVE_SRC / "Makefile"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    uname = os.uname()
    h.update(f"{uname.nodename} {uname.machine}".encode())
    return _NATIVE_BUILD / f"libqinco_ivf_{h.hexdigest()[:16]}.so"


def build_native() -> Path:
    """``make -C native`` into :func:`native_lib_path` unless the library
    is there; a temporary name and a rename keep concurrent builds apart.
    Raises ``RuntimeError`` with the compiler's output if make fails."""
    out = native_lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(["make", "-C", str(_NATIVE_SRC), f"CXX={native_cxx()}", f"TARGET={tmp}"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native IVF library failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Every exported function's argument and result types, as the C
    sources declare them."""
    c = ctypes
    f32p, i32p, i64p = c.POINTER(c.c_float), c.POINTER(c.c_int), c.POINTER(c.c_int64)
    sigs = {
        "qivf_new": (c.c_void_p, [c.c_int, c.c_int, c.c_int, c.c_int]),
        "qivf_free": (None, [c.c_void_p]),
        "qivf_nlist": (c.c_int, [c.c_void_p]),
        "qivf_code_m": (c.c_int, [c.c_void_p]),
        "qivf_code_k": (c.c_int, [c.c_void_p]),
        "qivf_dim": (c.c_int, [c.c_void_p]),
        "qivf_code_bytes": (c.c_int, [c.c_void_p]),
        "qivf_ntotal": (c.c_int64, [c.c_void_p]),
        "qivf_list_size": (c.c_int64, [c.c_void_p, c.c_int]),
        "qivf_set_norm_quant": (None, [c.c_void_p, c.c_float, c.c_float]),
        "qivf_train_norm": (None, [c.c_void_p, f32p, c.c_int64]),
        "qivf_add_entries": (None, [c.c_void_p, c.c_int, c.c_int64, i64p,
                                    c.POINTER(c.c_uint8), f32p]),
        "qivf_search": (None, [c.c_void_p, c.c_int64, i32p, f32p, f32p, c.c_int, c.c_int,
                               i64p, i32p, f32p, c.c_int]),
        "qivf_search_split": (None, [c.c_void_p, c.c_int64, i32p, f32p, f32p, f32p, c.c_int,
                                     c.c_int, i64p, i32p, f32p, c.c_int]),
        "qivf_search_qlut": (None, [c.c_void_p, c.c_int64, i32p, f32p, f32p, c.c_int, c.c_int,
                                    i64p, i32p, f32p, c.c_int]),
        "qpw_decode": (None, [f32p, i32p, i32p, i32p, c.c_int, c.c_int, c.c_int, i32p, c.c_int,
                              c.c_int64, c.c_int, c.c_int, f32p, c.c_int]),
        "qpw_score": (None, [f32p, i32p, i32p, c.c_int, c.c_int, c.c_int, i32p, c.c_int,
                             c.c_int, c.c_int, f32p, f32p, c.c_int64, c.c_int64, f32p,
                             c.c_int]),
        "qivf_save": (c.c_int, [c.c_void_p, c.c_char_p]),
        "qivf_load": (c.c_void_p, [c.c_char_p]),
        "qhnsw_build": (c.c_void_p, [f32p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_uint64]),
        "qhnsw_free": (None, [c.c_void_p]),
        "qhnsw_search": (None, [c.c_void_p, f32p, c.c_int64, c.c_int, c.c_int, i32p, f32p,
                                c.c_int]),
        "qhnsw_save": (c.c_int, [c.c_void_p, c.c_char_p]),
        "qhnsw_load": (c.c_void_p, [c.c_char_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


@functools.lru_cache(maxsize=1)
def get_lib() -> ctypes.CDLL:
    return _declare(ctypes.CDLL(str(build_native())))


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class HnswQuantizer:
    """Native HNSW coarse quantizer over the IVF centroids (on the host,
    chosen by ``search.coarse=hnsw``)."""

    def __init__(self, handle):
        if not handle:
            raise RuntimeError("the native HNSW call returned no graph")
        self._lib = get_lib()
        self._h = ctypes.c_void_p(handle)

    @classmethod
    def build(cls, centroids: np.ndarray, *, M: int = 32, ef_construction: int = 20,
              seed: int = 0) -> "HnswQuantizer":
        cent = np.ascontiguousarray(centroids, np.float32)
        n, d = cent.shape
        return cls(get_lib().qhnsw_build(_ptr(cent, ctypes.c_float), n, d, M, ef_construction,
                                         seed))

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.qhnsw_free(self._h)

    def search(self, xq: np.ndarray, k: int, *, ef: int = 16, nthreads: int = 0):
        """-> (indices (nq, k) int32, squared distances (nq, k) f32)."""
        xq = np.ascontiguousarray(xq, np.float32)
        nq = len(xq)
        out_idx = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        self._lib.qhnsw_search(self._h, _ptr(xq, ctypes.c_float), nq, k, ef,
                               _ptr(out_idx, ctypes.c_int), _ptr(out_d, ctypes.c_float),
                               nthreads)
        return out_idx, out_d

    def save(self, path) -> None:
        if self._lib.qhnsw_save(self._h, str(path).encode()) != 0:
            raise OSError(f"failed to save HNSW to {path}")

    @classmethod
    def load(cls, path) -> "HnswQuantizer":
        h = get_lib().qhnsw_load(str(path).encode())
        if not h:
            raise OSError(f"failed to load HNSW from {path}")
        return cls(h)


class IvfIndex:
    """Native packed-inverted-list index with AQ codebooks, whose probe and
    LUTs run on ``device`` (default ``cuda``).

    Host side: the IVF centroids and the AQ codebooks (numpy, for the
    lists' norms); the device holds copies for the probe and the LUTs.
    ``norm_mode``: ``"resid"`` stores ‖r‖² of the AQ reconstruction and
    scans with per-(query, list) LUTs −2(q−c)·C (or their split form);
    ``"full"`` (paired K² codes) stores the relative norm ‖y‖² − ‖c‖² and
    scans with the query-only LUT −2q·C, with the bias ‖q − c‖².  The
    coarse quantizer is the exact top-nprobe on the device, unless
    :meth:`use_hnsw` switches to the native HNSW graph."""

    def __init__(self, handle, ivf_centroids: np.ndarray, codebooks: np.ndarray,
                 norm_mode: str = "resid", device=None):
        if not handle:
            raise RuntimeError("the native index call returned no index")
        if norm_mode not in ("resid", "full"):
            raise ValueError(f"norm_mode must be 'resid' or 'full', got {norm_mode!r}")
        self._lib = get_lib()
        self._h = ctypes.c_void_p(handle)
        self.device = resolve_device(device)
        self.ivf_centroids = np.ascontiguousarray(ivf_centroids, np.float32)
        self.codebooks = np.ascontiguousarray(codebooks, np.float32)  # (M, K, D)
        self.norm_mode = norm_mode
        # files written before relative norms store the absolute ||y||²
        self._legacy_abs_norms = False
        self.hnsw: HnswQuantizer | None = None
        self.ef_search = 16
        self._cterm: np.ndarray | None = None  # split-LUT (nlist, M, K) table
        self._cent_norms: np.ndarray | None = None
        self._cent_dev = torch.as_tensor(self.ivf_centroids, device=self.device)
        M, K, D = self.codebooks.shape
        self._cb_dev = torch.as_tensor(self.codebooks, device=self.device)
        self._cb2d_dev = self._cb_dev.reshape(M * K, D)

    def use_hnsw(self, *, M: int = 32, ef_construction: int = 20, ef_search: int = 16,
                 seed: int = 0) -> None:
        """Build (or rebuild) the native HNSW coarse quantizer."""
        self.hnsw = HnswQuantizer.build(self.ivf_centroids, M=M,
                                        ef_construction=ef_construction, seed=seed)
        self.ef_search = ef_search

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, ivf_centroids: np.ndarray, codebooks: np.ndarray, norm_mode: str = "resid",
              device=None) -> "IvfIndex":
        nlist, D = ivf_centroids.shape
        M, K, D2 = codebooks.shape
        if D2 != D or K > 65536:
            raise ValueError(f"codebooks {codebooks.shape} do not fit D={D}, K <= 65536")
        return cls(get_lib().qivf_new(nlist, M, K, D), ivf_centroids, codebooks,
                   norm_mode=norm_mode, device=device)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.qivf_free(self._h)

    @property
    def nlist(self) -> int:
        return self._lib.qivf_nlist(self._h)

    @property
    def M(self) -> int:
        return self._lib.qivf_code_m(self._h)

    @property
    def K(self) -> int:
        return self._lib.qivf_code_k(self._h)

    @property
    def ntotal(self) -> int:
        return self._lib.qivf_ntotal(self._h)

    @property
    def code_bytes(self) -> int:
        return self._lib.qivf_code_bytes(self._h)

    def list_size(self, list_no: int) -> int:
        return self._lib.qivf_list_size(self._h, list_no)

    @property
    def cent_norms(self) -> np.ndarray:
        """Exact ‖c‖² per list (float64 sums), cached."""
        if self._cent_norms is None:
            self._cent_norms = (self.ivf_centroids.astype(np.float64) ** 2).sum(-1).astype(
                np.float32)
        return self._cent_norms

    def train_norm(self, norms: np.ndarray, list_nos=None) -> None:
        """Train the int8 norm quantizer on ‖r‖² (``"resid"``) or on the
        full ‖c + r‖² with their ``list_nos`` (``"full"``: the exact ‖c‖²
        is taken off first)."""
        norms = np.ascontiguousarray(norms, np.float32)
        if self.norm_mode == "full" and not self._legacy_abs_norms:
            if list_nos is None:
                raise ValueError("norm_mode='full' needs list_nos to train the relative norms")
            norms = np.ascontiguousarray(norms - self.cent_norms[np.asarray(list_nos)],
                                         np.float32)
        self._lib.qivf_train_norm(self._h, _ptr(norms, ctypes.c_float), len(norms))

    def add_entries(self, list_no: int, ids, codes, norms) -> None:
        """Append to one list: ``codes (n, M)`` < K, ``norms (n,)`` as for
        :meth:`train_norm`."""
        ids = np.ascontiguousarray(ids, np.int64)
        codes = np.ascontiguousarray(codes, np.uint8 if self.code_bytes == 1 else np.uint16)
        norms = np.asarray(norms, np.float32)
        if self.norm_mode == "full" and not self._legacy_abs_norms:
            norms = norms - self.cent_norms[list_no]
        norms = np.ascontiguousarray(norms, np.float32)
        n = len(ids)
        if codes.shape != (n, self.M) or norms.shape != (n,):
            raise ValueError(f"codes {codes.shape} / norms {norms.shape} for {n} ids, M={self.M}")
        self._lib.qivf_add_entries(self._h, list_no, n, _ptr(ids, ctypes.c_int64),
                                   codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                   _ptr(norms, ctypes.c_float))

    def add_batch(self, ids, list_nos, codes, norms) -> None:
        """Group a batch by list (stable) and append each group."""
        list_nos = np.asarray(list_nos)
        order = np.argsort(list_nos, kind="stable")
        sorted_lists = list_nos[order]
        bounds = np.flatnonzero(np.diff(sorted_lists)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(order)]])
        ids, codes, norms = np.asarray(ids), np.asarray(codes), np.asarray(norms)
        for s, e in zip(starts, ends):
            sel = order[s:e]
            self.add_entries(int(sorted_lists[s]), ids[sel], codes[sel], norms[sel])

    # -- search -------------------------------------------------------------
    def enable_split_lut(self, max_bytes: int = 4 << 30) -> bool:
        """Precompute the per-centroid half of the LUT,
        LUT[q, p] = −2 q·C + 2 c_p·C = qterm[q] + cterm[list(p)], so the
        scan never holds the (nq, nprobe, M, K) tensor.  cterm is
        (nlist, M, K) f32, computed once on the device; returns False (the
        classic LUTs stay) for a ``"full"`` index or when it would exceed
        ``max_bytes``."""
        M, K, _ = self.codebooks.shape
        if self.norm_mode == "full" or self.nlist * M * K * 4 > max_bytes:
            return False
        cterm = 2.0 * (self._cent_dev @ self._cb2d_dev.T)
        self._cterm = np.ascontiguousarray(cterm.cpu().numpy(), np.float32)
        return True

    def _scan(self, fn, probe_lists, tables, bias, nshort, nthreads):
        nq, nprobe = probe_lists.shape
        probe_lists = np.ascontiguousarray(probe_lists, np.int32)
        bias = np.ascontiguousarray(bias, np.float32)
        tables = [np.ascontiguousarray(t, np.float32) for t in tables]
        out_ids = np.empty((nq, nshort), np.int64)
        out_codes = np.empty((nq, nshort, self.M + 1), np.int32)
        out_dists = np.empty((nq, nshort), np.float32)
        fn(self._h, nq, _ptr(probe_lists, ctypes.c_int),
           *(_ptr(t, ctypes.c_float) for t in tables), _ptr(bias, ctypes.c_float), nprobe,
           nshort, _ptr(out_ids, ctypes.c_int64), _ptr(out_codes, ctypes.c_int),
           _ptr(out_dists, ctypes.c_float), nthreads)
        return out_ids, out_codes, out_dists

    def scan(self, probe_lists, luts, bias, nshort: int, nthreads: int = 0):
        """Classic scan: ``luts (nq, nprobe, M, K)``, ``bias (nq, nprobe)``."""
        return self._scan(self._lib.qivf_search, probe_lists, [luts], bias, nshort, nthreads)

    def scan_split(self, probe_lists, qterm, bias, nshort: int, nthreads: int = 0):
        """Split-LUT scan: ``qterm (nq, M, K)`` = −2 q·C and the index's cterm."""
        if self._cterm is None:
            raise RuntimeError("call enable_split_lut() first")
        return self._scan(self._lib.qivf_search_split, probe_lists, [qterm, self._cterm], bias,
                          nshort, nthreads)

    def scan_qlut(self, probe_lists, qlut, bias, nshort: int, nthreads: int = 0):
        """Query-only-LUT scan of a ``"full"`` index: ``qlut (nq, M, K)``,
        ``bias`` ‖q − c‖² (relative norms) or ‖q‖² − 2q·c (legacy)."""
        if self.norm_mode != "full":
            raise RuntimeError("the qlut scan needs a norm_mode='full' index")
        return self._scan(self._lib.qivf_search_qlut, probe_lists, [qlut], bias, nshort,
                          nthreads)

    def _qterm(self, xq: torch.Tensor) -> np.ndarray:
        """−2 q·C for every codeword, ``(nq, M, K)`` on the host."""
        M, K, _ = self.codebooks.shape
        return (-2.0 * (xq @ self._cb2d_dev.T)).reshape(-1, M, K).cpu().numpy()

    def search_and_return_codes(self, xq: np.ndarray, nshort: int, *, nprobe: int,
                                nthreads: int = 0, coarse_batch: int = 8192):
        """Full search: the probe and LUTs on the device, the native scan.
        Returns ``(dists (nq, nshort), ids (nq, nshort), codes (nq, nshort,
        M + 1))``, the codes with the list number in column 0."""
        xq = np.asarray(xq, np.float32)
        out = []
        for i in range(0, len(xq), coarse_batch):
            chunk = xq[i:i + coarse_batch]
            chunk_dev = torch.as_tensor(chunk, device=self.device)
            if self.hnsw is not None:
                probes, bias = self.hnsw.search(chunk, nprobe, ef=max(self.ef_search, nprobe),
                                                nthreads=nthreads)
            else:
                probes, bias = (t.cpu().numpy() for t in coarse_probe(
                    chunk_dev, self._cent_dev, nprobe))
            if self.norm_mode == "full":
                M, K, _ = self.codebooks.shape
                # relative norms: the bias is ||q - c||², as the probe gives it;
                # legacy absolute norms want ||q||² - 2 q.c
                bias_f = bias - self.cent_norms[probes] if self._legacy_abs_norms else bias
                # the qlut takes M*K*4 bytes a query: blocks of about 256 MB
                qb = max(64, (256 << 20) // (M * K * 4))
                subs = [self.scan_qlut(probes[j:j + qb], self._qterm(chunk_dev[j:j + qb]),
                                       bias_f[j:j + qb], nshort, nthreads)
                        for j in range(0, len(chunk), qb)]
                out.append(tuple(np.concatenate([s[t] for s in subs]) for t in range(3)))
            elif self._cterm is not None:
                out.append(self.scan_split(probes, self._qterm(chunk_dev), bias, nshort,
                                           nthreads))
            else:
                luts = build_luts(chunk_dev, self._cent_dev, self._cb_dev,
                                  torch.as_tensor(probes, device=self.device).long())
                out.append(self.scan(probes, luts.cpu().numpy(), bias, nshort, nthreads))
        ids = np.concatenate([o[0] for o in out])
        codes = np.concatenate([o[1] for o in out])
        dists = np.concatenate([o[2] for o in out])
        return dists, ids, codes

    # -- serialization ------------------------------------------------------
    def save(self, path) -> None:
        if self._lib.qivf_save(self._h, str(path).encode()) != 0:
            raise OSError(f"failed to save index to {path}")
        np.savez(  # uncompressed: float centroids and books barely compress
            str(path) + ".meta.npz", ivf_centroids=self.ivf_centroids, codebooks=self.codebooks,
            norm_mode=np.asarray(self.norm_mode),
            norm_rel=np.asarray(not self._legacy_abs_norms))

    @classmethod
    def load(cls, path, device=None) -> "IvfIndex":
        h = get_lib().qivf_load(str(path).encode())
        if not h:
            raise OSError(f"failed to load index from {path}")
        meta = np.load(str(path) + ".meta.npz")
        norm_mode = str(meta["norm_mode"]) if "norm_mode" in meta.files else "resid"
        idx = cls(h, meta["ivf_centroids"], meta["codebooks"], norm_mode=norm_mode,
                  device=device)
        if norm_mode == "full" and not ("norm_rel" in meta.files and bool(meta["norm_rel"])):
            idx._legacy_abs_norms = True
        return idx


# ---------------------------------------------------------------------------
# The coarse probe and the LUTs on the device
# ---------------------------------------------------------------------------


def coarse_probe(xq: torch.Tensor, centroids: torch.Tensor, nprobe: int, chunk: int = 65536):
    """The ``nprobe`` nearest centroids of each query, in f32, the book
    scanned in ``chunk``-row slices: ``(probe lists (nq, nprobe) int32,
    exact ‖q − c‖² (nq, nprobe))``.

    Each slice's candidates are merged with the running best by a stable
    sort, so ties go to the smaller index, in ``lax.top_k``'s order.  The
    last slice is zero-padded to ``chunk`` rows whose distances are
    :data:`PAD_DIST` (finite).  The bias of the chosen centroids is then
    recomputed as a sum of squared differences."""
    K = centroids.shape[0]
    chunk = min(chunk, K)
    n_chunks = -(-K // chunk)
    pad = n_chunks * chunk - K
    cent = centroids.float()
    if pad:
        cent = torch.cat([cent, cent.new_zeros((pad, cent.shape[1]))])
    xq = xq.float()
    nq = xq.shape[0]
    best_d = torch.full((nq, nprobe), 3.4e38, device=xq.device)
    best_i = torch.zeros((nq, nprobe), dtype=torch.int32, device=xq.device)
    for c in range(n_chunks):
        ids = torch.arange(c * chunk, (c + 1) * chunk, device=xq.device, dtype=torch.int32)
        d = pairwise_sqdist_partial(xq, cent[c * chunk:(c + 1) * chunk])
        d = torch.where(ids[None, :] < K, d, PAD_DIST)
        cand_d = torch.cat([best_d, d], dim=1)
        cand_i = torch.cat([best_i, ids.expand(nq, chunk)], dim=1)
        best_d, sel = torch.sort(cand_d, dim=1, stable=True)
        best_d, sel = best_d[:, :nprobe], sel[:, :nprobe]
        best_i = torch.gather(cand_i, 1, sel)
    diff = xq[:, None, :] - cent[best_i.long()]
    return best_i, (diff * diff).sum(-1)


def build_luts(xq: torch.Tensor, centroids: torch.Tensor, codebooks: torch.Tensor,
               probes: torch.Tensor) -> torch.Tensor:
    """LUT[q, p, m, k] = −2 (q − c_probe)·C_m[k] -> ``(nq, nprobe, M, K)`` f32."""
    resid = xq.float()[:, None, :] - centroids.float()[probes.long()]
    return -2.0 * torch.einsum("qpd,mkd->qpmk", resid, codebooks.float())
