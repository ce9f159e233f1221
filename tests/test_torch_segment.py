"""The port's deterministic segment sum and the row gather whose gradient
goes through it (``qinco_torch/ops/segment.py``), on the CPU: against
``index_add_``, against ``jax.ops.segment_sum`` and against plain
autograd.  Sums of f32 values in another order agree to f32 rounding:
rtol 1e-5, atol 1e-5 (each segment sums at most a few hundred values of
magnitude about 1).  The card's cases are in ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

from qinco_torch.ops.segment import gather_rows, segment_counts, segment_offsets, segment_sum

CASES = [(1000, 7, 3), (4096, 256, 16), (300, 1000, 8), (1, 5, 4), (0, 5, 4)]


def _inputs(n, K, D, seed=0):
    rng = np.random.default_rng(seed)
    # skewed ids: some segments empty, some long
    ids = np.minimum(rng.geometric(4.0 / max(K, 1), size=n) - 1, K - 1).astype(np.int64)
    return rng.standard_normal((n, D)).astype(np.float32), ids


@pytest.mark.parametrize("n, K, D", CASES)
def test_segment_sum_matches_index_add_and_jax(n, K, D):
    x, ids = _inputs(n, K, D)
    got = segment_sum(torch.from_numpy(x), torch.from_numpy(ids), K)
    want = torch.zeros((K, D)).index_add_(0, torch.from_numpy(ids), torch.from_numpy(x))
    assert got.shape == (K, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    jax_sum = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids), num_segments=K))
    np.testing.assert_allclose(got.numpy(), jax_sum, rtol=1e-5, atol=1e-5)


def test_segment_sum_adds_each_segment_in_row_order():
    """A segment's rows are added first to last: with values whose sum
    depends on the order, the result is the left-to-right f32 sum."""
    x = torch.tensor([[1e8], [1.0], [-1e8], [1.0]], dtype=torch.float32)
    ids = torch.tensor([0, 1, 0, 0])
    got = segment_sum(x, ids, 2)
    assert got[0, 0].item() == ((np.float32(1e8) + np.float32(-1e8)) + np.float32(1.0))
    assert got[1, 0].item() == 1.0


def test_segment_offsets_bound_each_segment():
    ids = torch.tensor([3, 0, 3, 1, 0, 3])
    order, offsets = segment_offsets(ids, 5)
    assert offsets.tolist() == [0, 2, 3, 3, 6, 6]
    assert ids[order].tolist() == [0, 0, 1, 3, 3, 3]
    assert order.tolist() == [1, 4, 3, 0, 2, 5]  # stable: row order within a segment


@pytest.mark.parametrize("n, K, D", CASES)
def test_segment_counts_match_bincount(n, K, D):
    _, ids = _inputs(n, K, D)
    got = segment_counts(torch.from_numpy(ids), K)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.bincount(ids, minlength=K))


def test_segment_sum_refuses_mismatched_rows():
    with pytest.raises(ValueError, match="rows"):
        segment_sum(torch.zeros((3, 2)), torch.zeros((4,), dtype=torch.long), 2)


@pytest.mark.parametrize("shape", [(50,), (10, 5)])
def test_gather_rows_gradient_equals_plain_autograd(shape):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((16, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 16, size=shape))
    upstream = torch.from_numpy(rng.standard_normal(shape + (6,)).astype(np.float32))
    a = table.clone().requires_grad_()
    b = table.clone().requires_grad_()
    out_a, out_b = gather_rows(a, ids), b[ids]
    assert torch.equal(out_a, out_b)
    (out_a * upstream).sum().backward()
    (out_b * upstream).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_gather_rows_without_grad_is_a_plain_gather():
    table = torch.arange(12.0).reshape(4, 3)
    ids = torch.tensor([2, 0, 2])
    assert torch.equal(gather_rows(table, ids), table[ids])
    assert gather_rows(table, ids).grad_fn is None
