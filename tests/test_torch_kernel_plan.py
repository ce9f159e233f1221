"""The launch plans of the selected-scores (B2) and select-rebuild (B3)
kernels, worked out on the CPU from the shapes alone, and the zero padding
of a low-rank concat factor for the tensor cores.

The plans are held at the qinco2-S, -M and -L widths (D = 128, K = 256,
A = 16, B = 32), at a normal beam step (N = 1024 vectors x F_in = 32 beam
rows) and at the IVF first step (F_in = 1, A = 32):

- a block's dynamic shared memory is at most 232,448 bytes (sm_90);
- the bf16 MLP tile is at least 128 pairs at qinco2-S widths and at least
  64 at the qinco2-M and -L widths;
- a launch offers at least 132 work items (one per SM of an H100) and
  launches one block per SM, or one per item when there are fewer;
- the work items cover the rows (or vectors) exactly once;
- where no tile fits, or a width is not a multiple of the mma tile, the
  plan raises: there is no fallback to another kernel.
"""

import numpy as np
import pytest
import torch

from qinco_torch.config import load_config
from qinco_torch.models.params import init_params
from qinco_torch.models.spec import QincoSpec, spec_from_cfg
from qinco_torch.ops import kernels

SMEM_LIMIT = 232_448
SMS = 132
N = 1024
PRESETS = ("qinco2-S", "qinco2-M", "qinco2-L")
# (F_in, A): a normal step, the IVF first step
STEPS = {"step": (32, 16), "ivf_first": (1, 32)}


def _spec(preset):
    return spec_from_cfg(load_config([f"model_args={preset}", "encode_profile=parity"]), D=128)


def _proj(spec):
    return spec.De != spec.D


def _selected_plan(spec, F_in, A, bf16=True, topa=True):
    stages = 1 + int(spec.fast) + 2 * spec.L + int(_proj(spec))
    return kernels.selected_plan(N * F_in, A, spec.D, spec.K, spec.De, spec.dh, bf16=bf16,
                                 topa=topa, stages=stages, sms=SMS)


def _rebuild_plan(spec, F_in, A, bf16=True):
    stages = 2 * int(_proj(spec)) + 1 + 2 * spec.L
    return kernels.rebuild_plan(N, F_in * A, spec.B, spec.D, spec.De, spec.dh, spec.De,
                                bf16=bf16, low_rank=False, stages=stages, sms=SMS)


def _check_common(plan, n):
    assert plan.mma
    assert plan.smem <= SMEM_LIMIT
    assert plan.items >= SMS, f"{plan.items} work items for {SMS} SMs"
    assert plan.blocks == min(plan.items, SMS)
    assert plan.per_item * plan.items >= n > plan.per_item * (plan.items - 1)


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("preset", PRESETS)
def test_selected_plan_fills_the_card(preset, step):
    spec = _spec(preset)
    F_in, A = STEPS[step]
    plan = _selected_plan(spec, F_in, A)
    _check_common(plan, N * F_in)
    assert plan.tm >= (128 if preset == "qinco2-S" else 64)
    assert plan.per_item & (plan.per_item - 1) == 0 and plan.per_item <= 32


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("preset", PRESETS)
def test_rebuild_plan_fills_the_card(preset, step):
    spec = _spec(preset)
    F_in, A = STEPS[step]
    plan = _rebuild_plan(spec, F_in, A)
    _check_common(plan, N)
    assert plan.tm >= (128 if preset == "qinco2-S" else 64)
    assert plan.per_item * spec.B <= max(plan.tm, spec.B)


@pytest.mark.parametrize("topa", [True, False], ids=["in-kernel top-A", "external vals"])
def test_selected_plan_at_the_main_step(topa):
    """qinco2-S at the main path's step: 128-pair tiles, 32 rows a work
    item, 1024 items on 132 blocks."""
    plan = _selected_plan(_spec("qinco2-S"), 32, 16, topa=topa)
    assert (plan.tm, plan.per_item, plan.items, plan.blocks) == (128, 32, 1024, 132)


def test_plans_at_the_ivf_first_step_split_rows_finer():
    """NF = 1024 beam rows: 4 rows (128 pairs) a work item gives 256
    items, where 32 rows a block gave 32 blocks."""
    spec = _spec("qinco2-S")
    plan = _selected_plan(spec, 1, 32)
    assert (plan.tm, plan.per_item, plan.items) == (128, 4, 256)
    assert _rebuild_plan(spec, 1, 32).per_item == 4


@pytest.mark.parametrize("preset", PRESETS)
def test_f32_plans_are_the_cuda_core_kernels(preset):
    """compute_dtype=float32 keeps the CUDA-core kernels: 32 beam rows or
    8 vectors a block, the largest MLP tile of 64 / 32 / 16 rows that fits."""
    spec = _spec(preset)
    D, K, De, Dh, A = spec.D, spec.K, spec.De, spec.dh, spec.A
    sel = _selected_plan(spec, 32, A, bf16=False)
    want = next(tm for tm in (64, 32, 16) if 4 * (32 * D + 32 * De + 32 * A + max(
        32 * D + K * 33, tm * (D + De + max(Dh, D)))) <= SMEM_LIMIT)
    assert (sel.mma, sel.tm, sel.per_item, sel.blocks) == (False, want, 32, N * 32 // 32)
    reb = _rebuild_plan(spec, 32, A, bf16=False)
    assert (reb.mma, reb.per_item, reb.blocks) == (False, 8, N // 8)
    assert reb.smem <= SMEM_LIMIT


@pytest.mark.parametrize("widths", [dict(De=2048, Dh=2048), dict(De=1024, Dh=4096)],
                         ids=["De=Dh=2048", "Dh=4096"])
def test_plans_raise_where_no_tile_fits(widths):
    De, Dh = widths["De"], widths["Dh"]
    with pytest.raises(ValueError, match="no tile fits"):
        kernels.selected_plan(N * 32, 16, 128, 256, De, Dh, bf16=True, topa=True, stages=6)
    with pytest.raises(ValueError, match="no tile fits"):
        kernels.rebuild_plan(N, 512, 32, 128, De, Dh, De, bf16=True, low_rank=False, stages=5)


def test_plans_raise_on_widths_off_the_mma_tile():
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.selected_plan(N * 32, 16, 128, 256, 136, 256, bf16=True, topa=True, stages=6)
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.rebuild_plan(N, 512, 32, 128, 128, 256, 8, bf16=True, low_rank=True, stages=6)


def test_plans_raise_on_too_many_products():
    with pytest.raises(ValueError, match="products"):
        kernels.selected_plan(N * 32, 16, 128, 256, 128, 256, bf16=True, topa=True, stages=65)
    with pytest.raises(ValueError, match="products"):
        kernels.rebuild_plan(N, 512, 32, 128, 128, 256, 128, bf16=True, low_rank=False,
                             stages=65)


@pytest.mark.parametrize("rank", [8, 16, 20])
def test_pad_rank_round_trip(rank):
    """The tensor-core route pads the low-rank factor's rank to a multiple
    of 16 with zeros: the original weights come back out of the padded
    ones, and the low-rank product is unchanged."""
    spec = QincoSpec(D=32, K=64, M=2, L=1, de=48, dh=64, A=8, B=8, concat_rank=rank,
                     compute_dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    p = init_params(spec, g, device="cpu").step(0)
    p = p._replace(concat_w2=torch.randn(p.concat_w2.shape, generator=g))
    w = kernels._chain_weights(spec, p)
    padded = kernels.pad_rank(w)
    width = -(-rank // 16) * 16
    assert padded.concat_w.shape == (w.concat_w.shape[0], width)
    assert padded.concat_w2.shape == (width, w.concat_w2.shape[1])
    assert torch.equal(padded.concat_w[:, :rank], w.concat_w)
    assert torch.equal(padded.concat_w2[:rank], w.concat_w2)
    assert not padded.concat_w[:, rank:].any() and not padded.concat_w2[rank:].any()
    for name in ("in_proj", "concat_b", "ffn_up", "ffn_down", "out_proj"):
        assert getattr(padded, name) is getattr(w, name)
    cat = torch.from_numpy(np.random.default_rng(1).normal(size=(5, w.concat_w.shape[0])))
    want = (cat @ w.concat_w.double()) @ w.concat_w2.double()
    got = (cat @ padded.concat_w.double()) @ padded.concat_w2.double()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if rank % 16 == 0:
        assert padded is w
