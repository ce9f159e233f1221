"""Static model specification (counterpart of ``qinco_tpu/models/spec.py``).

The fields are those of the JAX package, one for one, so a config and a
checkpoint's hyper-parameters mean the same thing to both packages.  On
the card some of them select a route, and some are kept only so that
configs carry over:

- ``compute_dtype``: dtype of the MLP matmul inputs ("float32" or
  "bfloat16"); products always accumulate in float32.
- ``fast``: the lean-fetch precision class of the selected-scores kernel
  (bf16 substep products, folded weight ``P·(I+W1)``); without it that
  kernel fetches through the folded table ``[C | C·P·(I+W1)]``.  In the
  plain route it fetches codewords rounded to bf16, as the JAX one-hot
  product does.  The substep and IVF step-0 distances stay f32 (as JAX
  computes them on the CPU).
- ``pallas``: run the beam steps through the hand-written kernels of
  :mod:`qinco_torch.ops.kernels` (the name is kept for configs).
- ``fused_topa``: exact top-A inside the selected-scores kernel (with
  ``fast``); off, the exact top-A is taken outside and its packed values
  enter the kernel (the external-vals route).
- ``fused_select``: ignored on the card.  The kernel route always runs
  beam top-B + rebuild in the select-rebuild kernel where the ids are
  packed (K <= 256); the JAX package's unfused tail computes the same
  function.
- ``fused_substep``: the speed profile's binned-argmin kernel
  (power-of-two K <= 256, A | K).  ``fold_up`` picks its table layout.
  ``perbin`` has no effect on the card: it picks one of two TPU layouts
  of the same function.
- ``approx_beam``: the per-step beam top-k stays exact (the TPU's
  approximate top-k is exact on the CPU too); the final re-pick of the
  winning beam by an exact argmin of the B survivors' distances runs as
  in the JAX package.
- ``row_tile``, ``select_tile``: TPU VMEM tiling knobs; ignored on the
  card, whose kernels size their own tiles.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QincoSpec:
    D: int  # data dimension
    K: int = 256  # codewords per step
    M: int = 8  # number of (non-IVF) quantization steps
    L: int = 2  # residual FFN blocks per step
    de: int | None = 128  # embed dim (None -> D)
    dh: int = 256  # FFN hidden dim
    A: int = 16  # substep candidates (0 = disabled, score all K)
    B: int = 32  # beam width (1 = greedy)
    ivf_K: int = 0  # IVF codebook size; 0 = no IVF step
    qinco1_mode: bool = False
    concat_rank: int | None = None  # QINCo-LR low-rank concat factor
    compute_dtype: str = "float32"
    fast: bool = False
    pallas: bool = False
    fused_substep: bool = False
    fold_up: bool = True
    approx_beam: bool = False
    perbin: bool = False
    row_tile: int = 0
    fused_select: bool = False
    fused_topa: bool = True
    select_tile: int = 0

    # ---- derived sizes ---------------------------------------------------
    @property
    def De(self) -> int:
        return self.de or self.D

    @property
    def ivf_in_use(self) -> bool:
        return self.ivf_K > 0

    @property
    def M_ivf(self) -> int:
        """Total number of codebooks incl. the IVF step."""
        return self.M + 1 if self.ivf_in_use else self.M

    @property
    def n_mlp_steps(self) -> int:
        """Steps carrying an MLP: all but step 0."""
        return self.M_ivf - 1

    @property
    def K_vals(self) -> tuple[int, ...]:
        ks = [self.K] * self.M
        if self.ivf_in_use:
            ks.insert(0, self.ivf_K)
        return tuple(ks)

    @property
    def K0(self) -> int:
        return self.ivf_K if self.ivf_in_use else self.K

    @property
    def beam0(self) -> int:
        """Beam width coming out of step 0."""
        return 1 if self.ivf_in_use else min(self.B, self.K0)

    def n_codes_at(self, i_mlp: int) -> int:
        """Substep candidate count for MLP step ``i_mlp`` (0-based over MLP
        steps).  The first beam-expanding step needs >= B candidates."""
        if self.A == 0:
            return self.K
        expanding = (i_mlp == 0) and self.ivf_in_use
        return max(self.B, self.A) if expanding else self.A

    def has_substep(self) -> bool:
        return self.A > 0

    @property
    def res_codeword_coeff(self) -> float:
        """QINCo2 adds the raw codeword back after the MLP; QINCo1 does not."""
        return 0.0 if self.qinco1_mode else 1.0

    def with_(self, **kw) -> "QincoSpec":
        return dataclasses.replace(self, **kw)


def spec_from_cfg(cfg, D: int) -> QincoSpec:
    """Build the static spec from a loaded Config + known data dim."""
    return QincoSpec(
        D=D,
        K=int(cfg.K),
        M=int(cfg.M),
        L=int(cfg.L),
        de=(int(cfg.de) if cfg.de else None),
        dh=int(cfg.dh),
        A=int(cfg.A or 0),
        B=int(cfg.B or 1),
        ivf_K=int(cfg.ivf_K) if (cfg.ivf_in_use and cfg.ivf_K) else 0,
        qinco1_mode=bool(cfg.qinco1_mode),
        compute_dtype=str(cfg.get("compute_dtype", "float32")),
        fast=bool(cfg.get("fast_encode", False)),
        pallas=bool(cfg.get("pallas", False)),
        fused_substep=bool(cfg.get("fused_substep", False)),
        perbin=bool(cfg.get("perbin", False)),
        approx_beam=bool(cfg.get("approx_beam", False)),
        fused_select=bool(cfg.get("fused_select", False)),
        fused_topa=bool(cfg.get("fused_topa", True)),
        fold_up=bool(cfg.get("fold_up", True)),
        row_tile=int(cfg.get("row_tile", 0) or 0),
        select_tile=int(cfg.get("select_tile", 0) or 0),
    )
