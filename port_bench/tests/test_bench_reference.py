"""The plain reference against the program on the CPU at a tiny size, on
the same weights: decode, the exact encode, the training losses and
their gradients, and AdamW.  (This test may import both.)"""

import pytest
import torch

import gen
import program
from reference import qinco_ref

TINY = dict(D=16, K=16, M=3, L=2, de=24, dh=32, A=4, B=4, ivf_K=256, encode_profile="exact",
            batch=256, optimizer="adamw", lr=0.0008, wd=0.1, grad_clip=0.1)
CPU = torch.device("cpu")


def setup(de=24):
    cfg = dict(TINY, de=de)
    shp = qinco_ref.Shape.of(cfg)
    W = gen.random_weights(shp, 1234, CPU)
    x = torch.from_numpy(gen.synthetic_data(W, shp, 512, 1234, 0.05))
    return cfg, shp, W, x, program.spec(cfg), program.params(W)


@pytest.mark.parametrize("de", [16, 24])
def test_decode_matches_the_program(de):
    cfg, shp, W, x, spec, params = setup(de)
    codes = torch.stack([torch.randint(0, k, (64,)) for k in [256, 16, 16, 16]])
    got = qinco_ref.decode(W, codes)
    want = program.qinco.decode(params, spec, codes.int())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("de", [16, 24])
def test_exact_encode_matches_the_program(de):
    cfg, shp, W, x, spec, params = setup(de)
    ref = qinco_ref.encode(W, shp, x)
    codes, _, _ = program.qinco.encode(params, spec, x)
    assert (ref == codes.long()).float().mean() >= 0.999
    e_r = ((x - qinco_ref.decode(W, ref)) ** 2).sum(-1).mean()
    e_p = ((x - qinco_ref.decode(W, codes)) ** 2).sum(-1).mean()
    assert abs(float(e_p / e_r) - 1) < 1e-5


def test_losses_gradients_and_adamw_match_the_program():
    cfg, shp, W, x, spec, params = setup()
    codes = qinco_ref.encode(W, shp, x)
    names = qinco_ref.trainable(W)
    Wr = {k: (None if v is None else v.clone()) for k, v in W.items()}
    for k in names:
        Wr[k].requires_grad_(True)
    loss = qinco_ref.train_losses(Wr, x, codes)
    grads = torch.autograd.grad(loss, [Wr[k] for k in names])
    for k in names:
        W[k].requires_grad_(True)
    total, _ = program.qinco.train_losses(params, spec, x, codes.int())
    want = torch.autograd.grad(total, [W[k] for k in names])
    torch.testing.assert_close(loss, total, rtol=1e-6, atol=0)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)

    # three AdamW steps on the same gradients
    mine = {k: Wr[k].detach().clone() for k in names}
    theirs = [W[k].detach().clone().requires_grad_(True) for k in names]
    opt = qinco_ref.AdamW(mine, lr=0.0008, wd=0.1)
    topt = torch.optim.AdamW(theirs, lr=0.0008, weight_decay=0.1, eps=1e-8)
    for _ in range(3):
        opt.step(mine, dict(zip(names, grads)))
        for t, g in zip(theirs, grads):
            t.grad = g.clone()
        topt.step()
    for k, t in zip(names, theirs):
        torch.testing.assert_close(mine[k], t.detach(), rtol=1e-6, atol=1e-7)


def test_train_steps_follow_the_program_step():
    """Three steps of the reference against the program's train step at f32."""
    cfg, shp, W, x, spec, params = setup()
    batches = [x[i * 128:(i + 1) * 128] for i in range(3)]
    ref = qinco_ref.train_steps(W, shp, batches, cfg["lr"], cfg["wd"], cfg["grad_clip"])
    opt = program.train_step.build_optimizer(program.config(cfg), params, spec)
    step = program.train_step.make_train_step(spec, opt, cfg["grad_clip"])
    mstate = program.init_model_state(spec, device=CPU)
    losses = []
    for xb in batches:
        params, mstate, out = step(params, mstate, xb, torch.ones(len(xb)))
        losses.append(float(out.total_loss))
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for k in ref["weights"]:
        torch.testing.assert_close(W[k].detach(), ref["weights"][k], rtol=1e-4, atol=1e-6)
