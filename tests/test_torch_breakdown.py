"""The phase-breakdown kernels' plain versions (``qinco_torch.ops.breakdown``)
against the TPU kernels they replace, the bodies of
``scripts/ktopa_breakdown.py`` (``ktopa_kernel``, each of its nine modes)
and ``scripts/kernel_variants.py`` (``sel_kernel``, ``sel_fetch_kernel``),
imported from the scripts and run under ``pl.pallas_call(...,
interpret=True)`` with BlockSpecs of this file, on the same numpy inputs:
the scripts' widths (qinco2-S, L = 2, A = 16, B = 32, bf16) at 8 vectors
(256 beam rows), a row tile of 64.

Tolerances:
- packed scores (the nine modes): ids agree on >= 98% of slots and, where
  they agree, the unpacked values within rtol 1e-2 (atol 1e-5), the bf16
  limits of tests/test_torch_kernels.py for B2 and B4: XLA on the CPU
  skips some bf16 rounding points;
- ``sel`` (the packed bin minima, f32 sums): ids equal wherever the bin's
  two least substep distances are more than 1e-3 apart (the two sides sum
  in other orders), the unpacked values within rtol 1e-4, atol 1e-5;
- ``sel+fetch`` (sum of squares of bf16 table rows): where the winner's id
  agrees, rtol 1e-2 (the table's products round to bf16 on each side).

The port's plain ``full``, ``deferred``, ``perslot``, ``catfetch`` and
``tournament`` (sort, rounds, a one-hot product, bins) are held equal bit
for bit, and ``full`` to ``kernels.selected_scores_plain``.  ``nodist``'s
sums exact to float64 (``breakdown.nodist_exact``, against which the CUDA
tests hold its kernel) hold its plain version by ``tests/torch_exact.py``'s
rule and reject the same plain version with a planted fault.  Each entry
script runs its variants on the CPU at 2 vectors.  The beam step's build
compiles its four libraries and not the breakdown cuts.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from qinco_torch.ops import breakdown, kernels
from torch_exact import assert_near_exact

ROOT = Path(__file__).resolve().parent.parent
N, ROW_TILE = 8, 64  # vectors; beam rows of a grid step


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KB = _script("ktopa_breakdown")
KV = _script("kernel_variants")
TKB = _script("torch_ktopa_breakdown")
TKV = _script("torch_kernel_variants")


def _unpacked(v):
    return (np.ascontiguousarray(v).view(np.int32) & ~0xFF).view(np.float32)


def _ids(v):
    return np.ascontiguousarray(v).view(np.int32) & 0xFF


def _full_spec(a):
    return pl.BlockSpec(a.shape, lambda i: tuple(0 for _ in a.shape))


def _row_specs(js):
    return [pl.BlockSpec((ROW_TILE // js.B, js.D), lambda i: (i, 0)),
            pl.BlockSpec((ROW_TILE, js.D), lambda i: (i, 0))]


def _pallas(body, ops, js, width):
    NF = ops[1].shape[0]
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((NF, width), jnp.float32), grid=(NF // ROW_TILE,),
        in_specs=_row_specs(js) + [_full_spec(a) for a in ops[2:]],
        out_specs=pl.BlockSpec((ROW_TILE, width), lambda i: (i, 0)), interpret=True)(*ops))


@pytest.fixture(scope="module")
def ktopa_case():
    """The JAX script's operands (as its run_variant builds them) and the
    port's spec and step weights, on the inputs of TKB.make_inputs."""
    js, ts = KB.SPEC, TKB.SPEC
    kw = TKB.make_inputs(0, N)
    dt, De = jnp.bfloat16, js.De
    j = {k: jnp.asarray(v) for k, v in kw.items()}
    wfold = (jnp.eye(js.D, dtype=jnp.float32) + j["concat_w"][:De]).astype(dt)
    ops = [j["x"], j["xh"], j["sub_codebook"], j["codebook"].astype(dt), wfold,
           j["concat_w"][De:].astype(dt), j["concat_b"].reshape(1, -1),
           j["ffn_up"].astype(dt), j["ffn_down"].astype(dt)]
    x, xh = torch.from_numpy(kw["x"]), torch.from_numpy(kw["xh"])
    return js, ts, ops, x, xh, TKB.step_params(kw, "cpu")


@pytest.mark.parametrize("mode", kernels.KTOPA_MODES)
def test_ktopa_variant_plain_matches_the_script_kernel(ktopa_case, mode):
    js, ts, ops, x, xh, p = ktopa_case
    want = _pallas(lambda *refs: KB.ktopa_kernel(js, js.A, js.B, mode, *refs[:-1], refs[-1]),
                   ops, js, js.A)
    got = breakdown.ktopa_variant_plain(ts, x, xh, p, ts.A, mode).numpy()
    assert got.shape == want.shape == (N * js.B, js.A)
    same = _ids(got) == _ids(want)
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(_unpacked(got)[same], _unpacked(want)[same], rtol=1e-2, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors, and counts no launch
    before = dict(kernels.LAUNCHES)
    wrapped = breakdown.ktopa_variant(ts, x, xh, p, ts.A, mode).numpy()
    assert (wrapped.view(np.int32) == got.view(np.int32)).all()
    assert kernels.LAUNCHES == before


def test_ktopa_same_function_modes_are_bit_identical(ktopa_case):
    _, ts, _, x, xh, p = ktopa_case
    full = breakdown.ktopa_variant_plain(ts, x, xh, p, ts.A, "full").numpy().view(np.int32)
    b2 = kernels.selected_scores_plain(ts, x, xh, p, ts.A).numpy().view(np.int32)
    assert (full == b2).all()
    for mode in ("deferred", "perslot", "catfetch", "tournament"):
        got = breakdown.ktopa_variant_plain(ts, x, xh, p, ts.A, mode).numpy().view(np.int32)
        assert (got == full).all(), mode


def _skip_last_ffn_block(spec, p):
    return spec, p._replace(ffn_down=torch.cat([p.ffn_down[:-1], 0 * p.ffn_down[-1:]]))


# nodist's plain version, sound or with a fault planted through its inputs
# (as chip_smoke.nodist_faults plants them in the kernel)
NODIST_FAULTS = {
    "sound": lambda spec, p: (spec, p),
    "last_ffn_block_skipped": _skip_last_ffn_block,
    "cand_not_added": lambda spec, p: (spec.with_(qinco1_mode=True), p),
}


@pytest.mark.parametrize("fault", sorted(NODIST_FAULTS))
def test_nodist_exact_sums_hold_the_plain_version_and_reject_faults(ktopa_case, fault):
    _, ts, _, x, xh, p = ktopa_case
    exact = breakdown.nodist_exact(ts, x, xh, p, ts.A)
    plain = torch.from_numpy(_unpacked(breakdown.ktopa_variant_plain(ts, x, xh, p, ts.A,
                                                                     "nodist").numpy()))
    assert exact.shape == plain.shape == (N * ts.B, ts.A)
    spec_f, p_f = NODIST_FAULTS[fault](ts, p)
    got = torch.from_numpy(_unpacked(breakdown.ktopa_variant_plain(spec_f, x, xh, p_f, ts.A,
                                                                   "nodist").numpy()))
    if fault == "sound":
        assert_near_exact(got, plain, exact)
        assert (plain - exact).abs().max() <= 2 ** -8 * exact.abs().max()
    else:
        with pytest.raises(AssertionError, match="kernel - exact"):
            assert_near_exact(got, plain, exact)


@pytest.mark.parametrize("group", [0, 1])
def test_build_compiles_only_the_named_group(tmp_path, monkeypatch, group):
    """The first use of a beam-step kernel builds the four beam-step
    libraries and not the breakdown cuts, and the reverse."""
    monkeypatch.setenv("QINCO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    started = []

    class Nvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(Path(cmd[-1]).name)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            return "ptxas info", None

    monkeypatch.setattr(kernels.subprocess, "Popen", Nvcc)
    names = kernels._BUILD_GROUPS[group]
    assert sorted(kernels.build(names)) == sorted(names)
    assert sorted(started) == sorted(kernels._KERNELS[n][0] for n in names)
    assert sorted(n for g in kernels._BUILD_GROUPS for n in g) == sorted(kernels._KERNELS)
    assert kernels.build(names) == {}  # built: nothing to do


@pytest.fixture(scope="module")
def fused_case():
    """kernel_variants.py's operands (its run_variant's table) and the
    port's, on the inputs of TKV.make_inputs."""
    js, ts = KV.SPEC, TKV.SPEC
    kw = TKV.make_inputs(0, N)
    dt, De = jnp.bfloat16, js.de
    j = {k: jnp.asarray(v) for k, v in kw.items()}
    cp = jnp.dot(j["codebook"].astype(dt), j["in_proj"].astype(dt),
                 preferred_element_type=jnp.float32)
    table = jnp.concatenate(
        [j["codebook"], cp, jnp.dot(cp.astype(dt), j["concat_w"][:De].astype(dt),
                                    preferred_element_type=jnp.float32)], axis=1)
    x, xh = torch.from_numpy(kw["x"]), torch.from_numpy(kw["xh"])
    return js, ts, [j["x"], j["xh"], j["sub_codebook"]], table, x, xh, TKV.step_params(kw, "cpu")


def _sel_checks(ts, x, xh, p, got, want):
    """ids equal wherever the bin's two least values are > 1e-3 apart; the
    values within rtol 1e-4 where the ids agree."""
    w = kernels.fused_weights(ts, p)
    packed = kernels._substep_packed(ts, x.repeat_interleave(ts.B, 0) - xh, w.sub_t, w.cn2)
    two = np.sort(_unpacked(packed.numpy()).reshape(len(got), ts.A, -1), axis=2)[..., :2]
    distinct = two[..., 1] - two[..., 0] > 1e-3
    assert distinct.mean() > 0.9
    same = _ids(got) == _ids(want)
    assert same[distinct].all()
    np.testing.assert_allclose(_unpacked(got)[same], _unpacked(want)[same], rtol=1e-4, atol=1e-5)
    return same


def test_fused_cut_sel_matches_the_script_kernel(fused_case):
    js, ts, ops, _, x, xh, p = fused_case
    want = _pallas(lambda *refs: KV.sel_kernel(js, js.A, js.B, *refs), ops, js, js.A)
    got = breakdown.fused_cut_plain(ts, x, xh, p, ts.A, "sel").numpy()
    assert got.shape == want.shape == (N * js.B, js.A)
    _sel_checks(ts, x, xh, p, got, want)
    before = dict(kernels.LAUNCHES)
    wrapped = breakdown.fused_cut(ts, x, xh, p, ts.A, "sel").numpy()
    assert (wrapped.view(np.int32) == got.view(np.int32)).all()
    assert kernels.LAUNCHES == before


def test_fused_cut_sel_fetch_matches_the_script_kernel(fused_case):
    js, ts, ops, table, x, xh, p = fused_case
    # the script binds off_h = D, off_w1 = D + de (kernel_variants.py:791-794)
    want = _pallas(lambda *refs: KV.sel_fetch_kernel(js, js.A, js.B, js.D, js.D + js.de, *refs),
                   ops + [table], js, js.A)
    got = breakdown.fused_cut_plain(ts, x, xh, p, ts.A, "sel+fetch").numpy()
    assert got.shape == want.shape == (N * js.B, js.A)
    sel = breakdown.fused_cut_plain(ts, x, xh, p, ts.A, "sel").numpy()
    sel_j = _pallas(lambda *refs: KV.sel_kernel(js, js.A, js.B, *refs), ops, js, js.A)
    same = _sel_checks(ts, x, xh, p, sel, sel_j)
    np.testing.assert_allclose(got[same], want[same], rtol=1e-2, atol=1e-5)
    # the table is the script's: [C | C·P_in | (C·P_in)·W1], 384 wide
    assert breakdown.variant_table(ts, p).shape == (ts.K, 3 * ts.D)


def test_breakdown_wrappers_refuse_what_they_do_not_take(ktopa_case, fused_case):
    _, ts, _, x, xh, p = ktopa_case
    with pytest.raises(ValueError, match="mode must be one of"):
        breakdown.ktopa_variant(ts, x, xh, p, ts.A, "fetchb")
    with pytest.raises(ValueError, match="bfloat16"):
        breakdown.ktopa_variant(ts.with_(compute_dtype="float32"), x, xh, p, ts.A, "full")
    with pytest.raises(ValueError, match="lean fetch"):
        breakdown.ktopa_variant(ts.with_(fast=False), x, xh, p, ts.A, "full")
    with pytest.raises(ValueError, match="tournament needs"):
        breakdown.ktopa_variant(ts, x, xh, p, 24, "tournament")
    _, tf, _, _, xf, xhf, pf = fused_case
    with pytest.raises(ValueError, match="cut must be one of"):
        breakdown.fused_cut(tf, xf, xhf, pf, tf.A, "perbin")
    with pytest.raises(ValueError, match="A | K"):
        breakdown.fused_cut(tf, xf, xhf, pf, 24, "sel")


@pytest.mark.parametrize("script, variants", [
    ("torch_ktopa_breakdown", ",".join(("production",) + kernels.KTOPA_MODES)),
    ("torch_kernel_variants", "production,full,sel,self"),
])
def test_entry_script_runs_on_the_cpu(tmp_path, script, variants):
    out = tmp_path / "out.json"
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / f"{script}.py"), "--device", "cpu", "--n", "2",
         "--iters", "1", "--variants", variants, "--out", str(out)],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(out.read_text())
    assert got["batch"] == 2 and got["device"] == {"name": "cpu"}
    aliases = {"self": "sel+fetch", **kernels.KTOPA_ALIASES}  # timed under the kernel's name
    names = [aliases.get(v, v) for v in variants.split(",")]
    assert sorted(got["ms_per_step"]) == sorted(set(names))
    assert all(isinstance(ms, float) and ms > 0 for ms in got["ms_per_step"].values())


def test_entry_scripts_run_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script, variant in ((TKB, "full"), (TKV, "sel")):
        with pytest.raises(RuntimeError, match="CUDA device"):
            script.run([variant], n=2)
