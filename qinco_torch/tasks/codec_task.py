"""The QINCo1-era scripts as tasks (counterpart of
``qinco_tpu/tasks/codec_task.py``): ``encode_codec`` and ``decode_codec``
(the reference's ``qinco_v1/codec_qinco.py``) and ``search_2stage`` (its
``qinco_v1/search_2stage.py``)."""

from __future__ import annotations

import json

import numpy as np
import torch

from ..codec import read_codes_file, write_codes_file
from ..data.datasets import load_queries_data, load_vec_db, load_vec_trainset
from ..models.qinco import decode_raw, encode_chunked
from .base import BaseTask


class EncodeCodecTask(BaseTask):
    """Encode a vector file into a codes file through ``encode_chunked`` at
    ``batch`` vectors a chunk.  An ``output`` ending in ``.npy`` stores
    (N, M) int32 codes; any other extension writes the bit-packed format
    of :mod:`qinco_torch.codec`, for models without IVF only."""

    def setup(self):
        super().setup()
        if not self.cfg.model:
            raise ValueError("Specify 'model'")
        if not self.cfg.output:
            raise ValueError("Specify 'output' (.npy or packed codes file)")

    def load_data(self):
        self.db_vecs, _ = load_vec_db(self.cfg)
        self.data_dim = self.db_vecs.shape[-1]
        self.print(f"Input vectors: {self.db_vecs.shape}")

    def run(self):
        cfg = self.cfg
        codes = encode_chunked(self.params, self.spec, self.db_vecs, batch=cfg.batch,
                               enc_max_bs=cfg.enc_max_bs)  # (M_ivf, N)
        if str(cfg.output).endswith(".npy"):
            np.save(cfg.output, codes.T.astype(np.int32))
            self.print(f"Stored codes {codes.T.shape} in {cfg.output}")
        else:
            # one code width for every step: an IVF step-0 code would need its own
            if self.spec.ivf_in_use:
                raise ValueError("raw bit-packing supports flat models only; use a .npy "
                                 "output for IVF models")
            write_codes_file(cfg.output, codes, self.spec.K)
            nbits = max(1, int(np.ceil(np.log2(self.spec.K))))
            self.print(f"Packed {codes.shape[1]} vectors × {codes.shape[0]} codes "
                       f"@ {nbits} bits into {cfg.output}")
        return codes


class DecodeCodecTask(BaseTask):
    """Decode a codes file (``encoded_db``: codes ``.npy`` or a packed
    file) into a ``.npy`` vector file, ``batch`` vectors a ``decode_raw``
    call."""

    def setup(self):
        super().setup()
        cfg = self.cfg
        if not cfg.model:
            raise ValueError("Specify 'model'")
        if not cfg.encoded_db:
            raise ValueError("Specify 'encoded_db' (codes file)")
        if not (cfg.output and str(cfg.output).endswith(".npy")):
            raise ValueError("Specify a .npy output")

    def run(self):
        cfg, spec = self.cfg, self.spec
        path = str(cfg.encoded_db)
        if path.endswith(".npy"):
            codes = np.load(path).astype(np.int32)  # (N, M)
        else:
            codes, K = read_codes_file(path)
            if K != spec.K:
                raise ValueError(f"codes file K={K} vs model K={spec.K}")
        if codes.shape[1] != spec.M_ivf:
            raise ValueError(f"codes have {codes.shape[1]} steps, model expects {spec.M_ivf}")
        self.print(f"Decoding {codes.shape[0]} vectors")
        out = np.empty((len(codes), spec.D), np.float32)
        for i in range(0, len(codes), cfg.batch):
            chunk = torch.from_numpy(np.ascontiguousarray(codes[i:i + cfg.batch].T))
            out[i:i + cfg.batch] = decode_raw(self.params, spec,
                                              chunk.to(self.device)).cpu().numpy()
        np.save(cfg.output, out)
        self.print(f"Stored vectors {out.shape} in {cfg.output}")
        return out


class TwoStageSearchTask(BaseTask):
    """Flat two-stage search: an AQ look-up-table shortlist over the whole
    database, then the QINCo decode and exact rerank of the top
    ``nshort`` (:mod:`qinco_torch.search.two_stage`).  ``search.nshort``
    holds literal shortlist sizes, each at least 100."""

    NEEDS_TRAIN_DATA = True

    def setup(self):
        super().setup()
        if not self.cfg.model:
            raise ValueError("Specify 'model'")

    def load_data(self):
        cfg = self.cfg
        (self.train_vecs, _), _ = load_vec_trainset(cfg)
        self.db_vecs, _ = load_vec_db(cfg)
        self.xq, self.xq_gt = load_queries_data(cfg)
        self.data_dim = self.db_vecs.shape[-1]

    def run(self):
        from ..ops.aq import compute_fixed_aq_codebooks
        from ..search.two_stage import run_search_two_stage

        cfg, spec = self.cfg, self.spec
        if spec.ivf_in_use:
            raise ValueError("search_2stage is the flat (no-IVF) search; use task=search "
                             "with an index for IVF models")

        self.print("Encoding trainset for the AQ fit")
        xt = np.asarray(self.train_vecs, np.float32)
        xt_codes = encode_chunked(self.params, spec, xt, batch=cfg.batch,
                                  enc_max_bs=cfg.enc_max_bs)  # (M, nt)
        codebooks = compute_fixed_aq_codebooks(xt, xt_codes.T, k=spec.K, device=self.device)

        self.print("Encoding database")
        db_codes = encode_chunked(self.params, spec, self.db_vecs, batch=cfg.batch,
                                  enc_max_bs=cfg.enc_max_bs)

        results = {}
        for nshort in sorted(int(v) for v in cfg.search.nshort) or [100]:
            nshort = max(nshort, 100)
            _, recalls = run_search_two_stage(
                self.params, spec, db_codes, codebooks, np.asarray(self.xq, np.float32),
                np.asarray(self.xq_gt), nshort=nshort, decode_batch=cfg.search.batch_size,
                log=self.print)
            results[nshort] = {str(k): v for k, v in recalls.items()}
            self.print(f"nshort={nshort}: {results[nshort]}")
        if cfg.output:
            with open(cfg.output, "w") as f:
                json.dump(results, f)
        return results
