"""The QINCo1-era tasks through the port's command line, on the CPU
(``python -m qinco_torch task=convert|encode_codec|decode_codec|
search_2stage|train_pq|eval_pq ... cpu=true``), against the JAX package's
``run_qinco.main`` on the same files.

Bounds: converted npz leaves equal the JAX package's bit for bit; codes
of the two packages' encodes agree on >= 99% of entries; decodes of one
code file by the two packages agree to rtol 1e-5, atol 1e-5; recalls
within 0.01; the PQ DB MSE within rtol 1e-4 (as printed, 6 digits)."""

import json
import re

import numpy as np
import pytest
import torch
from torch_port_helpers import make_models, one_torch_thread  # noqa: F401

import run_qinco
from qinco_torch.__main__ import main
from qinco_torch.checkpoint import save_checkpoint

MODEL_HP = dict(K=16, M=4, L=1, de=16, dh=16, A=4, B=2)
D = 16


def port(args):
    assert main([*args, "cpu=true", "verbose=false"]) == 0


def jax_run(args):
    assert run_qinco.main([*args, "verbose=false"]) in (0, None)


def _npz_leaves(path):
    """The parameter and model-state leaves, and the metadata, of an npz
    checkpoint."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"]).decode())
        leaves = {k: z[k] for k in z.files if k.startswith(("params_", "mstate_"))}
    return leaves, meta


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


def _reference_state(rng, D, K, n_mlp, L, de, dh, *, substep, v1_layout=False, stats=True):
    """A reference-layout state dict: step 0's codebook, then ``n_mlp``
    MLP steps (torch Linear weights are (out, in)).  ``v1_layout`` nests
    the projections in ``residual_blocks.0`` and adds the stray step-0
    substep codebook; ``stats`` adds data_mean/std and the EMA buffers."""
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    sd = {"steps.0.codebook.weight": f32(K, D)}
    if v1_layout:
        sd["steps.0.substep.codebook.weight"] = f32(K, D)
    for m in range(1, n_mlp + 1):
        sd[f"steps.{m}.codebook.weight"] = f32(K, D)
        if substep:
            sd[f"steps.{m}.substep.codebook.weight"] = f32(K, D)
        sd[f"steps.{m}.concat.mlp.weight"] = f32(de, de + D)
        sd[f"steps.{m}.concat.mlp.bias"] = f32(de)
        proj = f"steps.{m}.residual_blocks.0." if v1_layout else f"steps.{m}."
        sd[proj + "in_proj.weight"] = f32(de, D)
        sd[proj + "out_proj.weight"] = f32(D, de)
        for l in range(L):
            sd[f"steps.{m}.residual_blocks.{l}.up_proj.weight"] = f32(dh, de)
            sd[f"steps.{m}.residual_blocks.{l}.down_proj.weight"] = f32(de, dh)
        if stats:
            sd[f"steps.{m}.xtarget_mean"] = f32(D)
            sd[f"steps.{m}.xtarget_var"] = f32(D).abs()
    if stats:
        sd["data_mean"] = f32(D)
        sd["data_std"] = torch.tensor(1.7)
    return sd


CONVERT = {
    # name: (D, n_mlp, parameters, extra CLI arguments)
    "qinco2": (12, 3, dict(K=16, M=4, de=8, dh=10, L=2, A=4, B=2), []),
    "qinco2_ivf": (12, 3, dict(K=16, M=3, de=8, dh=10, L=2, A=4, B=2, ivf_in_use=True), ["ivf"]),
    "v1_bigann1B": (128, 2, dict(K=16, M=3, de=8, dh=12, L=2, A=0, B=1, ivf_in_use=False,
                                 qinco1_mode=True), ["db=bigann1B"]),
}


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_convert_gives_the_jax_packages_npz(name, tmp_path):
    D, n_mlp, hp, extra = CONVERT[name]
    rng = np.random.default_rng(sorted(CONVERT).index(name))
    v1 = name.startswith("v1")
    sd = _reference_state(rng, D, hp["K"], n_mlp, hp["L"], hp["de"], hp["dh"],
                          substep=hp["A"] > 0, v1_layout=v1, stats=not v1)
    ckpt = {"epoch": 7, "model": sd, "parameters": hp}
    if not v1:
        ckpt["data_dim"] = D
    torch.save(ckpt, str(tmp_path / "ref.pt"))
    args = [f"model={tmp_path}/ref.pt"]
    if "ivf" in extra:
        np.save(tmp_path / "ivf.npy", rng.standard_normal((32, D)).astype(np.float32))
        args.append(f"ivf_centroids={tmp_path}/ivf.npy")
    args += [a for a in extra if a != "ivf"]

    port(["task=convert", *args, f"output={tmp_path}/port.npz"])
    jax_run(["task=convert", *args, f"output={tmp_path}/jax.npz"])
    got, meta_p = _npz_leaves(tmp_path / "port.npz")
    want, meta_j = _npz_leaves(tmp_path / "jax.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for key in ("epoch", "parameters", "data_dim"):
        assert meta_p[key] == meta_j[key], key
    if v1:
        from qinco_torch.tasks.convert_task import v1_dataset_norms

        dim, mean, std = v1_dataset_norms("bigann1B")
        assert dim == D
        np.testing.assert_array_equal(got[_leaf(got, -2)], mean)
        assert float(got[_leaf(got, -1)]) == np.float32(std)


def _leaf(leaves, i):
    """The name of parameter leaf ``i`` (negative from the end)."""
    return sorted(k for k in leaves if k.startswith("params_"))[i]


# ---------------------------------------------------------------------------
# encode_codec, decode_codec, search_2stage
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    """A random flat model, saved as a checkpoint, and its data: decodes of
    random codes plus N(0, 0.01²)."""
    from qinco_tpu.models import qinco as jq

    tmp = tmp_path_factory.mktemp("legacy_flat")
    js, ts, jp, tp, _ = make_models(seed=7, D=D, **MODEL_HP)
    save_checkpoint(tmp / "model.npz", params=tp, hyperparams=MODEL_HP, data_dim=D)
    rng = np.random.default_rng(7)

    def sample(n):
        src = rng.integers(0, js.K, size=(js.M, n)).astype(np.int32)
        return (np.asarray(jq.decode_raw(jp, js, src))
                + 0.01 * rng.standard_normal((n, D))).astype(np.float32)

    train, db = sample(1500), sample(800)
    queries = db[:40] + 0.01 * rng.standard_normal((40, D)).astype(np.float32)
    gt = np.argsort(((queries[:, None, :] - db[None]) ** 2).sum(-1), axis=1)[:, :10]
    for name, a in dict(train=train, db=db, queries=queries, gt=gt.astype(np.int32)).items():
        np.save(tmp / f"{name}.npy", a)
    return tmp


@pytest.fixture(scope="module")
def codec_files(flat):
    """Each package's encode of the DB, as .npy codes and as a packed file."""
    tmp = flat
    for run, who in ((port, "port"), (jax_run, "jax")):
        for ext in ("npy", "qcod"):
            run(["task=encode_codec", f"model={tmp}/model.npz", f"db={tmp}/db.npy",
                 f"output={tmp}/{who}_codes.{ext}", "batch=256"])
    return tmp


def test_encode_codec_matches_jax(codec_files):
    from qinco_torch.codec import read_codes_file

    tmp = codec_files
    port_codes, jax_codes = np.load(tmp / "port_codes.npy"), np.load(tmp / "jax_codes.npy")
    assert port_codes.shape == (800, MODEL_HP["M"]) and port_codes.dtype == np.int32
    assert (port_codes == jax_codes).mean() >= 0.99
    packed, K = read_codes_file(tmp / "port_codes.qcod")
    assert K == MODEL_HP["K"]
    np.testing.assert_array_equal(packed, port_codes)
    # 4 codes x 4 bits = 2 bytes a vector, after a 20-byte header
    assert (tmp / "port_codes.qcod").stat().st_size == 20 + 2 * 800


@pytest.mark.parametrize("codes", ["port_codes.npy", "port_codes.qcod", "jax_codes.npy",
                                   "jax_codes.qcod"])
def test_decode_codec_reads_either_packages_codes(codec_files, codes):
    tmp = codec_files
    stem = codes.replace(".", "_")
    port(["task=decode_codec", f"model={tmp}/model.npz", f"encoded_db={tmp}/{codes}",
          f"output={tmp}/{stem}_by_port.npy", "batch=256"])
    jax_run(["task=decode_codec", f"model={tmp}/model.npz", f"encoded_db={tmp}/{codes}",
             f"output={tmp}/{stem}_by_jax.npy", "batch=256"])
    got, want = np.load(tmp / f"{stem}_by_port.npy"), np.load(tmp / f"{stem}_by_jax.npy")
    assert got.shape == (800, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    db = np.load(tmp / "db.npy")
    assert ((got - db) ** 2).mean() < 0.5 * (db ** 2).mean()


def test_search_2stage_matches_jax(flat):
    tmp = flat
    args = ["task=search_2stage", f"model={tmp}/model.npz", f"trainset={tmp}/train.npy",
            f"db={tmp}/db.npy", f"queries={tmp}/queries.npy", f"queries_gt={tmp}/gt.npy",
            "search.nshort=[100,200]", "search.batch_size=512", "batch=256", "ds.valset=300"]
    port([*args, f"output={tmp}/port_2stage.json"])
    jax_run([*args, f"output={tmp}/jax_2stage.json"])
    got = json.loads((tmp / "port_2stage.json").read_text())
    want = json.loads((tmp / "jax_2stage.json").read_text())
    assert set(got) == set(want) == {"100", "200"}
    for nshort in want:
        for k in ("1", "10", "100"):
            assert abs(got[nshort][k] - want[nshort][k]) <= 0.01, (nshort, got, want)
    assert got["100"]["100"] > 0.9


# ---------------------------------------------------------------------------
# train_pq, eval_pq
# ---------------------------------------------------------------------------


def _db_mse(out: str) -> float:
    return float(re.findall(r"PQ-QINCo DB MSE: (\S+)", out)[-1])


def test_train_pq_with_opq_then_eval_pq_in_both_packages(flat, capsys):
    tmp = flat
    port(["task=train_pq", f"trainset={tmp}/train.npy", f"output={tmp}/pq.pqnpz", "pq_parts=2",
          "opq=true", "M=2", "K=16", "L=1", "de=4", "dh=8", "A=0", "B=1", "batch=256",
          "ds.valset=256", "epochs=1", "scheduler.stop_patience=0"])
    assert (tmp / "pq.pqnpz").exists() and not list(tmp.glob("_pq_part*.npy"))
    assert "PQ-QINCo validation MSE" in capsys.readouterr().out
    args = [f"db={tmp}/db.npy", f"model={tmp}/pq.pqnpz", "batch=256", "ds.db=512",
            f"queries={tmp}/queries.npy", f"queries_gt={tmp}/gt.npy"]
    port(["task=eval_pq", *args])
    out_port = capsys.readouterr().out
    jax_run(["task=eval_pq", *args])
    out_jax = capsys.readouterr().out
    mse_port, mse_jax = _db_mse(out_port), _db_mse(out_jax)
    assert np.isfinite(mse_port)
    assert abs(mse_port - mse_jax) <= 1e-4 * mse_jax, (mse_port, mse_jax)
    assert "R@100=" in out_port
