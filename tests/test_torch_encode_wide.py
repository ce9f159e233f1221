"""The parity profile at D = 768 (Contriever's width, the
``qinco2-L-contriever`` preset's MLP widths) on the CPU, where the
beam-step kernels run as their plain versions, against the exact profile
(plain float32 beam search) on the same weights and data, while
``test_torch_encode_exact.py`` holds the exact profile against the JAX
package (its ``contriever_L`` case at D = 768).

Data: the decodes of random codes plus noise of std 0.05 a dimension (the
data's noise floor, as the benchmark makes it), so that each vector has a
code to find.  The parity profile rounds the MLP's inputs to bf16 at
every block (16 of them), which moves a decode by about 1% of its norm
(measured: at most 1.0%) and flips near-ties of the beam:
every step's codes must agree on >= 0.95 of the vectors (measured >=
0.98), the parity MSE may exceed the exact one by 5% at most, and a
parity decode (its encode's reconstruction, or the decode of the exact
codes) lies within 2% of its norm of the f32 one."""

import pytest
import torch

from qinco_torch.config import load_config
from qinco_torch.models import qinco
from qinco_torch.models.params import init_params
from qinco_torch.models.spec import spec_from_cfg

N = 64
# the preset's MLP widths (L = 16, de = dh = 384, K = 256); two MLP steps,
# a beam of 8 and 8 candidates a row keep the CPU's work to seconds
SIZES = ["M=2", "B=8", "A=8", "ivf_K=256"]


def _models(D):
    def spec(profile):
        return spec_from_cfg(load_config(["model_args=qinco2-L-contriever",
                                          f"encode_profile={profile}", "ivf_in_use=true",
                                          *SIZES]), D=D)

    parity, exact = spec("parity"), spec("exact")
    g = torch.Generator().manual_seed(D)
    p = init_params(exact, g, device="cpu")
    std = 0.05 * 4 / exact.L  # the zero-initialized concat and FFN-down weights, filled
    steps = p.steps._replace(**{f: a + std * torch.randn(a.shape, generator=g)
                                for f, a in p.steps._asdict().items()
                                if a is not None and not a.any()})
    p = p._replace(codebook0=torch.randn(p.codebook0.shape, generator=g), steps=steps)
    codes = torch.stack([torch.randint(0, k, (N,), generator=g)
                         for k in [exact.ivf_K] + [exact.K] * exact.M]).int()
    x = qinco.decode(p, exact, codes) + 0.05 * torch.randn((N, D), generator=g)
    return parity, exact, p, x


@pytest.mark.parametrize("D", [768])
def test_parity_encode_and_decode_follow_the_exact_profile(D):
    parity, exact, p, x = _models(D)
    assert parity.pallas and parity.fast and parity.compute_dtype == "bfloat16"
    c_e, x_e, _ = qinco.encode(p, exact, x)
    c_p, x_p, _ = qinco.encode(p, parity, x)
    assert c_p.shape == c_e.shape == (parity.M_ivf, N)
    assert ((c_p == c_e).float().mean(1) >= 0.95).all()
    mse_e, mse_p = ((x - x_e) ** 2).sum(-1).mean(), ((x - x_p) ** 2).sum(-1).mean()
    assert mse_p <= 1.05 * mse_e, (float(mse_p), float(mse_e))

    def near(got, want):
        assert ((got - want).norm(dim=-1) <= 0.02 * want.norm(dim=-1)).all()

    near(x_p, qinco.decode(p, exact, c_p))
    near(qinco.decode(p, parity, c_e), qinco.decode(p, exact, c_e))
