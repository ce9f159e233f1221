"""A run on the CPU at qinco2-S's widths (a smaller IVF book and host array), with the timed path broken underneath,
reads ``correct`` false: the harness's look for a card is skipped, the
rest of the run is the benchmark's.  One case per fault each kind of cell
can have (one card: no exchange between cards to leave out)."""

import pytest

import program
from conftest import run_cpu

SEED = ["--seed", "2400000017", "--seconds", "1"]


def half_left_out(codes):
    codes = codes.clone()
    codes[:, codes.shape[1] // 2:] = 0
    return codes


def altered(codes, K=256):
    codes = codes.clone()
    codes[2] = (codes[2] + 1) % K
    return codes


def test_a_sound_encode_run_is_correct(tiny_root, capsys):
    rc, line = run_cpu(tiny_root, capsys, "--workload", "tiny.encode", *SEED)
    assert rc == 0 and line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [half_left_out, altered])
def test_encode_faults_read_incorrect(tiny_root, capsys, monkeypatch, fault):
    orig = program.qinco.encode_raw
    monkeypatch.setattr(program.qinco, "encode_raw",
                        lambda *a, **k: fault(orig(*a, **k)))
    rc, line = run_cpu(tiny_root, capsys, "--workload", "tiny.encode", *SEED)
    assert rc == 0 and not line["correct"], line["checks"]


def test_a_sound_train_run_is_correct(tiny_root, capsys):
    rc, line = run_cpu(tiny_root, capsys, "--workload", "tiny.train", *SEED)
    assert rc == 0 and line["correct"], line["checks"]


def unchanged_state(monkeypatch):
    build = program.train_step.build_optimizer

    def frozen(*a, **k):
        opt = build(*a, **k)
        opt.step = lambda *a, **k: None
        return opt

    monkeypatch.setattr(program.train_step, "build_optimizer", frozen)


def frozen_leaf(monkeypatch):
    """One small leaf, the concat layers' bias, left out of the optimizer:
    never updated."""
    build = program.train_step.build_optimizer

    def without_concat_b(cfg, params, spec):
        opt = build(cfg, params, spec)
        for group in opt.param_groups:
            group["params"] = [a for a in group["params"] if a is not params.steps.concat_b]
        return opt

    monkeypatch.setattr(program.train_step, "build_optimizer", without_concat_b)


def half_batch(monkeypatch):
    losses = program.train_step.train_losses

    def on_half(params, spec, x, codes, weights=None):
        w = weights.clone()
        w[len(w) // 2:] = 0
        return losses(params, spec, x, codes, w)

    monkeypatch.setattr(program.train_step, "train_losses", on_half)


def altered_code(monkeypatch):
    encode = program.train_step.encode

    def shifted(*a, **k):
        codes, xhat, stats = encode(*a, **k)
        return altered(codes), xhat, stats

    monkeypatch.setattr(program.train_step, "encode", shifted)


@pytest.mark.parametrize("plant", [unchanged_state, frozen_leaf, half_batch, altered_code])
def test_train_faults_read_incorrect(tiny_root, capsys, monkeypatch, plant):
    plant(monkeypatch)
    rc, line = run_cpu(tiny_root, capsys, "--workload", "tiny.train", *SEED)
    assert rc == 0 and not line["correct"], line["checks"]
