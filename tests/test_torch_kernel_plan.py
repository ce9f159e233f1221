"""The launch plans of the four beam-step kernels, worked out on the CPU from
the shapes alone: selected scores (B2), fused-substep scores (B4, each
table layout), candidate scores (B5, at K = 1024 and with a low-rank concat
factor) and select-rebuild (B3); and the zero padding of a low-rank concat
factor for the tensor cores.

The plans are held at the qinco2-S, -M and -L widths (D = 128, K = 256,
A = 16, B = 32), at a normal beam step (N = 1024 vectors x F_in = 32 beam
rows) and at the IVF first step (F_in = 1, A = 32):

- a block's dynamic shared memory is at most 232,448 bytes (sm_90);
- the bf16 MLP tile is at least 128 pairs at qinco2-S widths and at least
  64 at the qinco2-M and -L widths (B2's is 128 at all three: it holds the
  FFN hidden in registers);
- a launch offers at least 132 work items (one per SM of an H100) and
  launches one block per SM, or one per item when there are fewer;
- the work items cover the rows (or vectors) exactly once;
- where no tile fits, or a width is not a multiple of the mma tile, the
  plan raises: there is no fallback to another kernel.

Under float32 every kernel is its register-tiled f32 kernel (one block
per SM over work items, like the bf16 ones, a 64-pair tile at qinco2-S
and a 32-pair tile at -M and -L), and the same rules hold.
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


def _rebuild_plan(spec, F_in, A, bf16=True, rank=None):
    """The wrapper's stage count: [in_proj], concat, [concat_w2], the FFN
    blocks, [out_proj]; Wc the rank (padded to 16 under bf16) or De."""
    stages = 2 * int(_proj(spec)) + 1 + int(rank is not None) + 2 * spec.L
    Wc = spec.De if rank is None else rank if not bf16 else -(-rank // 16) * 16
    return kernels.rebuild_plan(N, F_in * A, spec.B, spec.D, spec.De, spec.dh, Wc,
                                bf16=bf16, low_rank=rank is not None, stages=stages, sms=SMS)


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
def test_selected_plan_wgmma_layout(preset, step):
    """B2's bf16 plan on wgmma: tile rows, ring and cluster from the shapes.
    128-pair tiles (two consumer warpgroups, one 64-row half each) at all
    three presets, the FFN hidden (Dh = 256 or 384: 2 or 3 passes of 128)
    in the warpgroups' registers and out of the layout, so cand and h of
    128 pairs fit beside the ring at the qinco2-M and -L widths too; a ring
    of 4 to 16 slabs of 64 x 128 bf16 after the head and the region; blocks
    a whole number of clusters, at most one an SM."""
    spec = _spec(preset)
    F_in, A = STEPS[step]
    plan = _selected_plan(spec, F_in, A)
    assert plan.tm == 128
    ring = kernels._selected_ring(plan.per_item, plan.tm, A, spec.D, spec.K, spec.De, spec.dh,
                                  True)
    assert ring % 128 == 0 and (plan.smem - ring) % 16384 == 0
    assert 4 <= (plan.smem - ring) // 16384 <= 16
    assert plan.cluster == 2 and plan.blocks % plan.cluster == 0
    assert plan.blocks <= SMS and plan.items >= SMS


@pytest.mark.parametrize("preset", PRESETS)
def test_selected_plan_pairs_a_weight_byte_feeds(preset):
    """Each weight byte B2 reads from L2 feeds tile x cluster pairs: 256 at
    all three presets (128-pair tiles, clusters of 2), where the 64-pair
    tiles of qinco2-M and -L fed 128 and the mma.sync kernel 128 and 64.  A
    launch with fewer work items than SMs runs no cluster."""
    spec = _spec(preset)
    plan = _selected_plan(spec, 32, 16)
    assert plan.tm * plan.cluster == 256
    small = kernels.selected_plan(100, 16, spec.D, spec.K, spec.De, spec.dh, bf16=True,
                                  topa=True, stages=2 + 2 * spec.L + int(_proj(spec)), sms=SMS)
    assert (small.cluster, small.blocks) == (1, small.items)


@pytest.mark.parametrize("shape", [(96, 200), (3, 384, 384), (2, 48, 16), (128, 128)],
                         ids=["96x200", "3x384x384", "2x48x16", "128x128"])
def test_wg_blocked_is_the_kernels_slab_layout(shape):
    """``wg_blocked`` lays a weight out as csrc/wgmma.cuh reads it: pass by
    pass (128 columns), slab by slab (64 rows), each slab W^T in 8 x 8 core
    matrices; rows past kin and columns past nout zero."""
    w = torch.randn(shape)
    got = kernels.wg_blocked(w)
    *lead, kin, nout = shape
    P, Kp = -(-nout // 128), -(-kin // 64) * 64
    assert got.shape == (*lead, Kp * P * 128)
    k = torch.arange(Kp)[:, None]
    n = torch.arange(P * 128)[None, :]
    p, s = n // 128, k // 64
    nn, kr = n % 128, k % 64
    off = (p * Kp + s * 64) * 128 + ((nn // 8) * 8 + kr // 8) * 64 + (nn % 8) * 8 + kr % 8
    want = torch.zeros((*lead, Kp, P * 128))
    want[..., :kin, :nout] = w
    torch.testing.assert_close(got[..., off], want, rtol=0, atol=0)


def test_selected_stream_bytes_at_qinco2_L():
    """The weight bytes a B2 launch streams from L2 (``kernels.
    weight_stream_bytes``): every work item's condition product, then each
    tile's products, in the slab layout, once a cluster."""
    spec = _spec("qinco2-L")
    plan = _selected_plan(spec, 32, 16)
    head = 128 * 3 * 128  # W2 (128, 384): 2 slabs of 64 rows x 3 passes
    tile = (128 * 3 * 128 * int(spec.fast) + 16 * 2 * 384 * 3 * 128
            + (384 * 1 * 128 if _proj(spec) else 0))  # [wfold], 16 x (U, D), [out_proj]
    tiles = -(-plan.per_item * 16 // plan.tm)
    got = kernels.selected_stream_bytes(plan, 16, spec.D, spec.De, spec.dh, spec.L,
                                        wfold=spec.fast, proj=_proj(spec))
    assert got == 2 * plan.items * (head + tiles * tile) // plan.cluster


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
    """compute_dtype=float32: B2' and B3 are register-tiled f32 kernels,
    one block per SM over work items, a 64-pair tile at the qinco2-S widths
    and a 32-pair tile at the qinco2-M and -L widths (where a 64-pair tile
    of f32 activations does not fit beside the weight ring): B2' up to 32
    beam rows an item, B3 a tile's worth of vectors (2 of F_out = 32 beams
    at qinco2-S, 1 at -M and -L)."""
    spec = _spec(preset)
    sel = _selected_plan(spec, 32, spec.A, bf16=False)
    want = (64, 32) if preset == "qinco2-S" else (32, 16)
    assert (sel.mma, sel.tm, sel.per_item) == (False, *want)
    _check_f32(sel, N * 32)
    reb = _rebuild_plan(spec, 32, spec.A, bf16=False)
    want = (64, 2) if preset == "qinco2-S" else (32, 1)
    assert (reb.mma, reb.tm, reb.per_item) == (False, *want)
    _check_f32(reb, N)


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


def _low_rank_step(rank: int, kind: str):
    """A bf16 spec with a low-rank concat factor of ``rank`` (B4's for
    ``kind`` fused) and a step's weights with random factors."""
    spec = QincoSpec(D=32, K=64, M=2, L=1, de=48, dh=64, A=8, B=8, concat_rank=rank,
                     fused_substep=kind == "fused", compute_dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    p = init_params(spec, g, device="cpu").step(0)
    return spec, p._replace(concat_w=torch.randn(p.concat_w.shape, generator=g),
                            concat_w2=torch.randn(p.concat_w2.shape, generator=g))


@pytest.mark.parametrize("rank", [8, 16, 20])
@pytest.mark.parametrize("kind", ["chain", "fused"])
def test_pad_rank_round_trip(kind, rank):
    """The tensor-core routes pad the low-rank factor's rank to a multiple
    of 16 with zeros: zero columns at the end of the chain's concat_w, or
    of B4's w2 and table (its W1 slice), zero rows of concat_w2.  A rank
    already a multiple of 16 gives the operands back uncopied.  The
    original operands come back out of the padded ones, the rest is the
    same, and the low-rank product is unchanged."""
    spec, p = _low_rank_step(rank, kind)
    if kind == "chain":
        w = kernels.chain_weights(spec, p)
        cols, rest = ("concat_w",), ("in_proj", "concat_b", "ffn_up", "ffn_down", "out_proj")
    else:
        w = kernels.fused_weights(spec, p)
        cols, rest = ("table", "w2"), ("sub_t", "cn2", "concat_b", "ffn_up", "ffn_down",
                                       "out_proj", "off_h", "off_w1", "off_up", "layout")
    padded = kernels.pad_rank(w)
    pad = -rank % 16
    if pad == 0:
        assert padded is w  # a rank already a multiple of 16: no copy
    assert padded.Wc == rank + pad and (padded.De, padded.Dh) == (w.De, w.Dh)
    for name in cols:
        a, b = getattr(w, name), getattr(padded, name)
        assert b.shape == (a.shape[0], a.shape[1] + pad)
        assert torch.equal(b[:, :a.shape[1]], a) and not b[:, a.shape[1]:].any()
    assert padded.concat_w2.shape == (rank + pad, w.concat_w2.shape[1])
    assert torch.equal(padded.concat_w2[:rank], w.concat_w2)
    assert not padded.concat_w2[rank:].any()
    for name in rest:
        assert getattr(padded, name) is getattr(w, name)
    if kind == "chain":
        cat = torch.from_numpy(np.random.default_rng(1).normal(size=(5, w.concat_w.shape[0])))
        want = (cat @ w.concat_w.double()) @ w.concat_w2.double()
        got = (cat @ padded.concat_w.double()) @ padded.concat_w2.double()
    else:
        lr = torch.from_numpy(np.random.default_rng(1).normal(size=(5, w.w2.shape[0])))
        t_w1 = w.table[:5, w.off_w1:].double()
        want = (t_w1 + lr @ w.w2.double()) @ w.concat_w2.double()
        got = (padded.table[:5, w.off_w1:].double() + lr @ padded.w2.double()) @ (
            padded.concat_w2.double())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# Each builder's streamed weights (what the kernel-form step lays out).
STREAMED = {
    "selected": ("wfold", "w2", "ffn_up", "ffn_down", "out_proj"),
    "fused": ("w2", "concat_w2", "ffn_up", "ffn_down", "out_proj"),
    "chain": ("in_proj", "concat_w", "concat_w2", "ffn_up", "ffn_down", "out_proj"),
}
BUILDERS = {"selected": kernels.selected_weights, "fused": kernels.fused_weights,
            "chain": kernels.chain_weights}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind,rank", [("selected", None), ("fused", None), ("fused", 20),
                                       ("chain", None), ("chain", 20)],
                         ids=["selected", "fused", "fused-rank20", "chain", "chain-rank20"])
def test_kernel_form_is_what_the_kernels_read(kind, rank, dtype):
    """Each builder's kernel form, field for field and bit for bit, against
    the operands composed by hand from the plain form: under bf16 B2's
    streamed weights ``wg_blocked(f32 weight, bf16)``, B3's, B4's and B5's
    the bf16 ones with a low-rank factor's rank padded to 16; under f32
    ``blocked(f32 weight)``; every other field the plain form's.  The width
    fields are those of the weights before any layout."""
    spec = QincoSpec(D=32, K=64, M=2, L=2, de=48, dh=64, A=8, B=8, fast=True,
                     fused_substep=kind == "fused", concat_rank=rank, compute_dtype=dtype)
    g = torch.Generator().manual_seed(1)
    p = init_params(spec, g, device="cpu").step(0)
    p = p._replace(**{f: torch.randn(getattr(p, f).shape, generator=g) for f in (
        "concat_w", "concat_w2", "concat_b") if getattr(p, f) is not None})
    build = BUILDERS[kind]
    got, plain = build(spec, p, kernel=True), build(spec, p)
    f32 = build(spec.with_(compute_dtype="float32"), p)  # the f32 weights, unlaid out
    bf16 = dtype == "bfloat16"
    pad = -rank % 16 if rank and bf16 and kind != "selected" else 0
    want = {}
    for name in STREAMED[kind]:
        if getattr(plain, name) is None:
            want[name] = None
        elif not bf16:
            want[name] = kernels.blocked(getattr(f32, name))
        elif kind == "selected":
            want[name] = kernels.wg_blocked(getattr(f32, name), torch.bfloat16)
        else:
            want[name] = getattr(plain, name)
    if pad:
        for name in ("table", "w2") if kind == "fused" else ("concat_w",):
            want[name] = torch.nn.functional.pad(getattr(plain, name), (0, pad))
        want["concat_w2"] = torch.nn.functional.pad(plain.concat_w2, (0, 0, 0, pad))
    for name in got._fields:
        a, b = getattr(got, name), want.get(name, getattr(plain, name))
        if name == "Wc":
            b = b + pad
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), name
            assert a.is_contiguous(), name
        else:
            assert a == b, name
    # the widths: of the unlaid-out weights, Wc the (padded) concat layer's
    assert (got.De, got.Dh) == tuple(plain.ffn_up.shape[1:]) == (spec.De, spec.dh)
    if kind != "selected":
        concat = plain.w2 if kind == "fused" else plain.concat_w
        assert got.Wc == concat.shape[1] + pad == (rank or spec.De) + pad
    if kind == "chain":
        assert got.low_rank == bool(rank)
    elif kind == "fused":
        assert (got.layout == "low_rank") == bool(rank) and got.has_in_proj


# The fused-substep table layouts (B4) and the candidate kinds (B5): the
# concat layer's width Wc is De, or the low-rank factor's rank padded to 16.
FUSED_LAYOUTS = {"fold_up": None, "folded": None, "low_rank": 8}
CANDIDATE_KINDS = {"K1024": None, "rank8": 8, "rank64": 64}


def _wc(spec, rank):
    return spec.De if rank is None else -(-rank // 16) * 16


def _fused_plan(spec, F_in, A, layout, bf16=True):
    """The wrapper's stage count: W2 (and U_0 with fold_up) once per item,
    then the per-tile products, [out_proj]."""
    L, rank = spec.L, FUSED_LAYOUTS[layout]
    stages = {"fold_up": 3 + 2 * (L - 1), "low_rank": 2 + 2 * L, "folded": 1 + 2 * L}[layout]
    return kernels.fused_plan(N * F_in, A, spec.D, spec.K, spec.De, spec.dh, _wc(spec, rank),
                              bf16=bf16, layout=layout, in_proj=_proj(spec),
                              stages=stages + int(_proj(spec)), sms=SMS)


def _candidate_plan(spec, F_in, A, kind, bf16=True):
    """The wrapper's stage count: the condition half once per item, then
    [in_proj], the codeword half, [concat_w2], the FFN blocks, [out_proj]."""
    rank = CANDIDATE_KINDS[kind]
    stages = 2 + 2 * int(_proj(spec)) + int(rank is not None) + 2 * spec.L
    return kernels.candidate_plan(N * F_in, A, spec.D, spec.De, spec.dh, _wc(spec, rank),
                                  bf16=bf16, in_proj=_proj(spec), low_rank=rank is not None,
                                  stages=stages, sms=SMS)


@pytest.mark.parametrize("layout", sorted(FUSED_LAYOUTS))
@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("preset", PRESETS)
def test_fused_plan_fills_the_card(preset, step, layout):
    spec = _spec(preset)
    F_in, A = STEPS[step]
    plan = _fused_plan(spec, F_in, A, layout)
    _check_common(plan, N * F_in)
    assert plan.tm >= (128 if preset == "qinco2-S" else 64)
    assert plan.per_item & (plan.per_item - 1) == 0 and plan.per_item <= 32


@pytest.mark.parametrize("kind", sorted(CANDIDATE_KINDS))
@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("preset", PRESETS)
def test_candidate_plan_fills_the_card(preset, step, kind):
    spec = _spec(preset)
    F_in, A = STEPS[step]
    plan = _candidate_plan(spec, F_in, A, kind)
    _check_common(plan, N * F_in)
    assert plan.tm >= (128 if preset == "qinco2-S" else 64)
    assert plan.per_item & (plan.per_item - 1) == 0 and plan.per_item <= 32


def test_scoring_plans_at_the_main_steps():
    """qinco2-S: B4 on the speed path takes 128-pair tiles at 16 rows a work
    item (32 rows and its per-row buffers would not fit beside them), B5 at
    K = 1024 128-pair tiles at 32 rows; at the IVF first step both take 4
    rows (128 pairs) a work item, 256 items."""
    spec = _spec("qinco2-S")
    plan = _fused_plan(spec, 32, 16, "fold_up")
    assert (plan.tm, plan.per_item, plan.items, plan.blocks) == (128, 16, 2048, 132)
    plan = _candidate_plan(spec, 32, 16, "K1024")
    assert (plan.tm, plan.per_item, plan.items, plan.blocks) == (128, 32, 1024, 132)
    assert (_fused_plan(spec, 1, 32, "fold_up").per_item,
            _candidate_plan(spec, 1, 32, "K1024").per_item) == (4, 4)


@pytest.mark.parametrize("preset", PRESETS)
def test_f32_scoring_plans_are_the_cuda_core_kernels(preset):
    """compute_dtype=float32: B4 (fold_up) and B5 are register-tiled f32
    kernels, one block per SM over work items of up to 32 rows, a 64-pair
    tile at the qinco2-S widths (B4 32 rows an item beside it, B5 16), a
    32-pair tile at the qinco2-M and -L widths (16 rows an item)."""
    spec = _spec(preset)
    A = spec.A
    fus = _fused_plan(spec, 32, A, "fold_up", bf16=False)
    assert (fus.mma, fus.tm, fus.per_item) == (False, *((64, 32) if preset == "qinco2-S"
                                                        else (32, 16)))
    _check_f32(fus, N * 32)
    cand = _candidate_plan(spec, 32, A, "K1024", bf16=False)
    assert (cand.mma, cand.tm, cand.per_item) == (False, *((64, 16) if preset == "qinco2-S"
                                                          else (32, 16)))
    _check_f32(cand, N * 32)


def _check_f32(plan, n):
    """An f32 plan: one block per SM (or per item when there
    are fewer), at least one work item per SM, the items covering the rows
    once, the shared memory within a block's."""
    assert not plan.mma
    assert plan.tm in (64, 32)
    assert plan.smem <= SMEM_LIMIT
    assert plan.items >= SMS, f"{plan.items} work items for {SMS} SMs"
    assert plan.blocks == min(plan.items, SMS)
    assert plan.per_item & (plan.per_item - 1) == 0 and plan.per_item <= 32
    assert plan.per_item * plan.items >= n > plan.per_item * (plan.items - 1)


@pytest.mark.parametrize("topa", [True, False], ids=["in-kernel top-A", "external vals"])
@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("preset", PRESETS)
def test_f32_selected_plan_fits(preset, step, topa):
    spec = _spec(preset)
    F_in, A = STEPS[step]
    plan = _selected_plan(spec, F_in, A, bf16=False, topa=topa)
    _check_f32(plan, N * F_in)
    assert plan.tm == (64 if preset == "qinco2-S" else 32)


@pytest.mark.parametrize("kind", sorted(CANDIDATE_KINDS))
@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("preset", PRESETS)
def test_f32_candidate_plan_fits(preset, step, kind):
    spec = _spec(preset)
    F_in, A = STEPS[step]
    plan = _candidate_plan(spec, F_in, A, kind, bf16=False)
    _check_f32(plan, N * F_in)
    assert plan.tm == (64 if preset == "qinco2-S" else 32)


@pytest.mark.parametrize("layout", sorted(FUSED_LAYOUTS))
@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("preset", PRESETS)
def test_f32_fused_plan_fits(preset, step, layout):
    spec = _spec(preset)
    F_in, A = STEPS[step]
    plan = _fused_plan(spec, F_in, A, layout, bf16=False)
    _check_f32(plan, N * F_in)
    assert plan.tm == (64 if preset == "qinco2-S" else 32)


@pytest.mark.parametrize("rank", [None, 8, 64], ids=["full", "rank8", "rank64"])
@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("preset", PRESETS)
def test_f32_rebuild_plan_fits(preset, step, rank):
    spec = _spec(preset)
    F_in, A = STEPS[step]
    plan = _rebuild_plan(spec, F_in, A, bf16=False, rank=rank)
    _check_f32(plan, N)
    assert plan.tm == (64 if preset == "qinco2-S" else 32)
    assert plan.per_item * spec.B <= plan.tm


def test_f32_plans_at_the_main_steps():
    """qinco2-S, f32: B2' and B4 (fold_up) take 64-pair tiles at 32 rows a
    work item, 1024 items on 132 blocks; B5 at K = 1024 64-pair tiles at 16
    rows, 2048 items; B3 64-pair tiles at 2 vectors, 512 items; at the
    IVF first step the scoring kernels take 4 rows (128 pairs) an item and
    B3 still 2 vectors."""
    spec = _spec("qinco2-S")
    plan = _selected_plan(spec, 32, 16, bf16=False, topa=False)
    assert (plan.tm, plan.per_item, plan.items, plan.blocks) == (64, 32, 1024, 132)
    plan = _candidate_plan(spec, 32, 16, "K1024", bf16=False)
    assert (plan.tm, plan.per_item, plan.items, plan.blocks) == (64, 16, 2048, 132)
    plan = _fused_plan(spec, 32, 16, "fold_up", bf16=False)
    assert (plan.tm, plan.per_item, plan.items, plan.blocks) == (64, 32, 1024, 132)
    plan = _rebuild_plan(spec, 32, 16, bf16=False)
    assert (plan.tm, plan.per_item, plan.items, plan.blocks) == (64, 2, 512, 132)
    assert (_selected_plan(spec, 1, 32, bf16=False).per_item,
            _candidate_plan(spec, 1, 32, "K1024", bf16=False).per_item,
            _fused_plan(spec, 1, 32, "fold_up", bf16=False).per_item,
            _rebuild_plan(spec, 1, 32, bf16=False).per_item) == (4, 4, 4, 2)


F32_KERNELS = ["selected", "candidate", "fused", "rebuild"]


@pytest.mark.parametrize("kernel", F32_KERNELS)
@pytest.mark.parametrize("widths", [dict(De=2048, Dh=2048), dict(De=1024, Dh=4096)],
                         ids=["De=Dh=2048", "Dh=4096"])
def test_f32_plans_raise_where_no_tile_fits(widths, kernel):
    De, Dh = widths["De"], widths["Dh"]
    with pytest.raises(ValueError, match="no tile fits"):
        if kernel == "selected":
            kernels.selected_plan(N * 32, 16, 128, 256, De, Dh, bf16=False, topa=False, stages=6)
        elif kernel == "candidate":
            kernels.candidate_plan(N * 32, 16, 128, De, Dh, De, bf16=False, in_proj=True,
                                   low_rank=False, stages=8)
        elif kernel == "fused":
            kernels.fused_plan(N * 32, 16, 128, 256, De, Dh, De, bf16=False, layout="fold_up",
                               in_proj=True, stages=6)
        else:
            kernels.rebuild_plan(N, 512, 32, 128, De, Dh, De, bf16=False, low_rank=False,
                                 stages=7)


@pytest.mark.parametrize("kernel", F32_KERNELS)
def test_f32_plans_raise_on_bad_widths_and_too_many_products(kernel):
    """Widths off the 4-wide loads, and more products than one weight
    stream holds, are refused: there is no fallback to another kernel."""
    with pytest.raises(ValueError, match="multiples of 4"):
        if kernel == "selected":
            kernels.selected_plan(N * 32, 16, 128, 256, 130, 256, bf16=False, topa=True, stages=6)
        elif kernel == "candidate":
            kernels.candidate_plan(N * 32, 16, 128, 128, 256, 6, bf16=False, in_proj=False,
                                   low_rank=True, stages=8)
        elif kernel == "fused":
            kernels.fused_plan(N * 32, 16, 128, 256, 128, 256, 6, bf16=False, layout="low_rank",
                               in_proj=False, stages=6)
        else:
            kernels.rebuild_plan(N, 512, 32, 128, 128, 256, 6, bf16=False, low_rank=True,
                                 stages=6)
    with pytest.raises(ValueError, match="products"):
        if kernel == "selected":
            kernels.selected_plan(N * 32, 16, 128, 256, 128, 256, bf16=False, topa=True,
                                  stages=65)
        elif kernel == "candidate":
            kernels.candidate_plan(N * 32, 16, 128, 128, 256, 128, bf16=False, in_proj=False,
                                   low_rank=False, stages=65)
        elif kernel == "fused":
            kernels.fused_plan(N * 32, 16, 128, 256, 128, 256, 128, bf16=False, layout="folded",
                               in_proj=False, stages=65)
        else:
            kernels.rebuild_plan(N, 512, 32, 128, 128, 256, 128, bf16=False, low_rank=False,
                                 stages=65)


@pytest.mark.parametrize("kernel", ["fused", "candidate"])
@pytest.mark.parametrize("widths", [dict(De=2048, Dh=2048), dict(De=1024, Dh=4096)],
                         ids=["De=Dh=2048", "Dh=4096"])
def test_scoring_plans_raise_where_no_tile_fits(widths, kernel):
    De, Dh = widths["De"], widths["Dh"]
    with pytest.raises(ValueError, match="no tile fits"):
        if kernel == "fused":
            kernels.fused_plan(N * 32, 16, 128, 256, De, Dh, De, bf16=True, layout="folded",
                               in_proj=True, stages=6)
        else:
            kernels.candidate_plan(N * 32, 16, 128, De, Dh, De, bf16=True, in_proj=True,
                                   low_rank=False, stages=8)


@pytest.mark.parametrize("kernel", ["fused", "candidate"])
def test_scoring_plans_raise_on_widths_off_the_mma_tile(kernel):
    """An unpadded rank of 8 (or a width of 136) is refused, not rounded."""
    with pytest.raises(ValueError, match="multiples of 16"):
        if kernel == "fused":
            kernels.fused_plan(N * 32, 16, 128, 256, 128, 256, 8, bf16=True, layout="low_rank",
                               in_proj=False, stages=6)
        else:
            kernels.candidate_plan(N * 32, 16, 128, 136, 256, 136, bf16=True, in_proj=True,
                                   low_rank=False, stages=8)


@pytest.mark.parametrize("kernel", ["fused", "candidate"])
def test_scoring_plans_raise_on_too_many_products(kernel):
    with pytest.raises(ValueError, match="products"):
        if kernel == "fused":
            kernels.fused_plan(N * 32, 16, 128, 256, 128, 256, 128, bf16=True, layout="folded",
                               in_proj=False, stages=65)
        else:
            kernels.candidate_plan(N * 32, 16, 128, 128, 256, 128, bf16=True, in_proj=False,
                                   low_rank=False, stages=65)


def test_fused_plan_raises_on_an_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        kernels.fused_plan(N * 32, 16, 128, 256, 128, 256, 128, bf16=True, layout="perbin",
                           in_proj=False, stages=6)


# ---------------------------------------------------------------------------
# The data's width D: the reference's datasets run D = 96 (Deep1B), 128
# (BigANN), 256 (FB-ssnpp) and 768 (Contriever).  B2 and B3 hold D whole
# where the one-pass plan fits, and take it in column passes where it does
# not (``LaunchPlan.d_passes``).
# ---------------------------------------------------------------------------

# (tm, rows or vectors an item, smem, items, blocks) of B2 and B3's plans at
# D <= 256, one-pass plans.  B2 holds the FFN hidden in registers at 128
# pairs, which gives qinco2-M and -L 128-pair tiles up to D = 128, and
# qinco2-S 32 rows an item at D = 256 (1 with the hidden in shared memory);
# at D = 256 cand and h alone keep qinco2-M and -L at 64 pairs.
ONE_PASS = {
    ("qinco2-S", 96, "step"): ((128, 32, 219904, 1024, 132), (128, 4, 138752, 256, 132)),
    ("qinco2-S", 96, "ivf_first"): ((128, 4, 226048, 256, 132), (128, 4, 131072, 256, 132)),
    ("qinco2-S", 128, "step"): ((128, 32, 232192, 1024, 132), (128, 4, 138752, 256, 132)),
    ("qinco2-S", 128, "ivf_first"): ((128, 4, 218368, 256, 132), (128, 4, 131072, 256, 132)),
    ("qinco2-S", 256, "step"): ((128, 32, 232192, 1024, 132), (128, 4, 204288, 256, 132)),
    ("qinco2-S", 256, "ivf_first"): ((128, 4, 220416, 256, 132), (128, 4, 196608, 256, 132)),
    ("qinco2-M", 96, "step"): ((128, 16, 220928, 2048, 132), (64, 2, 144384, 512, 132)),
    ("qinco2-M", 96, "ivf_first"): ((128, 4, 230144, 256, 132), (64, 2, 140544, 512, 132)),
    ("qinco2-M", 128, "step"): ((128, 16, 231168, 2048, 132), (64, 2, 148480, 512, 132)),
    ("qinco2-M", 128, "ivf_first"): ((128, 4, 222464, 256, 132), (64, 2, 144640, 512, 132)),
    ("qinco2-M", 256, "step"): ((64, 8, 218368, 4096, 132), (64, 2, 164864, 512, 132)),
    ("qinco2-M", 256, "ivf_first"): ((64, 4, 224512, 256, 132), (64, 2, 161024, 512, 132)),
    ("qinco2-L", 96, "step"): ((128, 16, 220928, 2048, 132), (64, 2, 144384, 512, 132)),
    ("qinco2-L", 96, "ivf_first"): ((128, 4, 230144, 256, 132), (64, 2, 140544, 512, 132)),
    ("qinco2-L", 128, "step"): ((128, 16, 231168, 2048, 132), (64, 2, 148480, 512, 132)),
    ("qinco2-L", 128, "ivf_first"): ((128, 4, 222464, 256, 132), (64, 2, 144640, 512, 132)),
    ("qinco2-L", 256, "step"): ((64, 8, 218368, 4096, 132), (64, 2, 164864, 512, 132)),
    ("qinco2-L", 256, "ivf_first"): ((64, 4, 224512, 256, 132), (64, 2, 161024, 512, 132)),
}


def _wide_spec(preset, D):
    return spec_from_cfg(load_config([f"model_args={preset}", "encode_profile=parity"]), D=D)


@pytest.mark.parametrize("key", sorted(ONE_PASS), ids=lambda k: f"{k[0]}-D{k[1]}-{k[2]}")
def test_plans_up_to_D256_hold_D_whole(key):
    """At D = 96, 128 and 256 both plans are one-pass plans, d_passes 1 (B2
    in clusters of 2, B3 none)."""
    preset, D, step = key
    spec = _wide_spec(preset, D)
    F_in, A = STEPS[step]
    b2, b3 = ONE_PASS[key]
    assert _selected_plan(spec, F_in, A) == kernels.LaunchPlan(*b2, True, 2, 1)
    assert _rebuild_plan(spec, F_in, A) == kernels.LaunchPlan(*b3, True, 1, 1)


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("preset", PRESETS)
def test_plans_at_D768_take_column_passes(preset, step):
    """At D = 768 no one-pass plan of B3 fits at any preset, nor of B2 at
    qinco2-M and -L: they take D in column passes, on a 64-pair tile, in
    at most a block's shared memory, with every SM a work item.  B2 at
    qinco2-S still fits D whole (64-pair tiles of 4 beam rows an item)."""
    spec = _wide_spec(preset, 768)
    F_in, A = STEPS[step]
    sel = _selected_plan(spec, F_in, A)
    _check_common(sel, N * F_in)
    if preset == "qinco2-S":
        assert (sel.tm, sel.per_item, sel.d_passes) == (64, 4, 1)
    else:
        assert (sel.tm, sel.d_passes, sel.cluster) == (64, 2, 2)
        ring = kernels._selected_ring(sel.per_item, 64, A, 768, spec.K, spec.De, spec.dh, True,
                                      kc=kernels.d_pass_width(768, sel.d_passes))
        assert 4 <= (sel.smem - ring) // 16384 <= 16 and (sel.smem - ring) % 16384 == 0
    reb = _rebuild_plan(spec, F_in, A)
    _check_common(reb, N)
    assert (reb.tm, reb.d_passes) == (64, 2)
    assert kernels.d_pass_width(768, reb.d_passes) == 384


@pytest.mark.parametrize("route", ["topa", "vals"])
@pytest.mark.parametrize("step", sorted(STEPS))
def test_contriever_plan_keeps_its_column_passes(step, route):
    """qinco2-L at D = 768 (the Contriever cell): B2's plan is the D-passed
    one it was, 64-pair tiles with the FFN hidden in shared memory (cand
    alone, (128, 768) bf16, is 196 KB at 128 pairs), 8 rows an item at a
    normal step, 2 column passes, clusters of 2."""
    spec = _wide_spec("qinco2-L", 768)
    F_in, A = STEPS[step]
    plan = _selected_plan(spec, F_in, A, topa=route == "topa")
    want = 8 if step == "step" else 4
    assert (plan.tm, plan.per_item, plan.d_passes, plan.cluster) == (64, want, 2, 2)


@pytest.mark.parametrize("preset", ["qinco2-M", "qinco2-L"])
def test_selected_ring_drops_the_hidden(preset):
    """SelectedLayout's ring offset at 128 pairs, R = 16 rows an item, the
    qinco2-M and -L widths, where the warpgroups hold the hidden in
    registers: exactly 2 x 128 x 384 bytes (the (128, Dh) bf16 hidden)
    below the same layout with the hidden in shared memory, composed here
    by hand, and at least 4 ring slots under the limit, where the
    shared-memory hidden leaves none."""
    spec = _spec(preset)
    D, K, De, Dh, R = spec.D, spec.K, spec.De, spec.dh, 16
    args = (R, 128, 16, D, K, De, Dh, True)
    regs = kernels._selected_ring(*args)
    # the barriers, r, ccb, vals, the partials; the region: rnd(xh), the
    # substep tile, or cand, h and the hidden of 128 pairs
    head = 256 + 4 * R * D + 4 * R * De + 4 * R * 16 + 2 * 64 * 4
    region = max(2 * 64 * D, 4 * R * D + 4 * K * (R + 1), 2 * 128 * (D + De + Dh))
    smem = -(-(head + region) // 128) * 128
    assert (smem, regs) == (263936, 165632)
    assert smem - regs == 2 * 128 * 384
    assert (kernels._SMEM_LIMIT - regs) // 16384 >= 4 > (kernels._SMEM_LIMIT - smem) // 16384
    assert kernels._selected_mma_smem(*args) == regs + 4 * 16384


def test_refetch_bytes_at_qinco2_L_D768():
    """The bytes the column passes read again, counted by hand at qinco2-L,
    D = 768, a normal step: De = 384 is 3 passes of 128 output columns.

    B2 (R = 8 rows an item, 2 tiles of 64 pairs an item, 4096 items): per
    item the f32 beam rows once for each of the condition product's 3
    passes, 3 x 8 x 768 x 4 B; per tile the bf16 codewords for the lean
    fetch's 2 passes after the first and for the distance, 3 x 64 x 768 x 2
    B.  B3 (2 vectors an item of 32 beams: one 64-pair tile, 512 items):
    per tile the f32 codewords (in_proj) and parent rows (the concat
    layer) for 2 passes each after the first, 4 x 64 x 768 x 4 B."""
    spec = _wide_spec("qinco2-L", 768)
    sel = _selected_plan(spec, 32, 16)
    assert (sel.per_item, sel.items) == (8, 4096)
    got = kernels.selected_refetch_bytes(sel, 16, 768, 384, wfold=True, res=True)
    assert got == 4096 * (3 * 8 * 768 * 4 + 2 * (3 * 64 * 768 * 2))
    reb = _rebuild_plan(spec, 32, 16)
    assert (reb.per_item, reb.items) == (2, 512)
    assert kernels.rebuild_refetch_bytes(reb, 32, 768, 384, 384, in_proj=True) == (
        512 * 4 * 64 * 768 * 4)
    one = _selected_plan(_wide_spec("qinco2-L", 128), 32, 16)
    assert kernels.selected_refetch_bytes(one, 16, 128, 384, wfold=True, res=True) == 0


@pytest.mark.parametrize("widths", [dict(De=2048, Dh=2048), dict(De=1024, Dh=4096)],
                         ids=["De=Dh=2048", "Dh=4096"])
def test_wide_plans_raise_where_no_pass_fits(widths):
    """At D = 768 the column passes do not rescue MLP widths whose h and
    hidden alone outgrow a block: the plans raise as at D = 128."""
    De, Dh = widths["De"], widths["Dh"]
    with pytest.raises(ValueError, match="no tile fits"):
        kernels.selected_plan(N * 32, 16, 768, 256, De, Dh, bf16=True, topa=True, stages=6)
    with pytest.raises(ValueError, match="no tile fits"):
        kernels.rebuild_plan(N, 512, 32, 768, De, Dh, De, bf16=True, low_rank=False, stages=5)
