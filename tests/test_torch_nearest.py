"""The IVF step 0, ``ops.distances.chunked_argmin``: the plain loop on the
CPU (its tie order across slices, its partial distances, the counter of
the rows it takes, the launch plan of the kernel that replaces it on the
card), and the hand-written kernel (``ops.kernels.nearest``,
``csrc/nearest.cu``) against the plain loop on the card.

The ``cuda`` cases skip without a CUDA device.  On a machine with a card
(JAX is not needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nearest.py -q

Tolerances on the card: the kernel and the plain loop (cuBLAS, TF32 off)
both compute ‖c‖² − 2 x·c in IEEE f32 and differ only in the summation
order of the D products.  A partial distance can sit near zero while its
terms do not (‖c‖² ≈ 2 x·c), so its error is held against the size of
its terms, ‖c‖² + 2 |x·c|, at rtol 1e-5 (a few f32 units at D = 768); two
winners may differ only where the exact (float64) distances of the two
are that close, a near tie that another summation order may flip.
"""

import contextlib

import numpy as np
import pytest
import torch

from qinco_torch import tracing
from qinco_torch.ops import kernels, kmeans
from qinco_torch.ops.distances import chunked_argmin, chunked_argmin_plain

RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(N, K, D, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((N, D), generator=g, device=device),
            torch.randn((K, D), generator=g, device=device))


def _exact(x, book, idx):
    """‖c‖² − 2 x·c of each row's ``idx`` in float64, and the size of its terms."""
    c, x = book[idx].double(), x.double()
    cc, xc = (c * c).sum(-1), (x * c).sum(-1)
    return cc - 2 * xc, cc + 2 * xc.abs()


# --- the plain loop, on the CPU ---------------------------------------------

# (chunk, row in slice 0, row in slice 3) of a 64-row book in 16-row slices
TIES = {"first_rows": (16, 0, 48), "last_rows": (16, 15, 63), "mid_rows": (16, 7, 55),
        "slice_ends": (16, 15, 48)}


@pytest.mark.parametrize("case", sorted(TIES))
def test_plain_argmin_ties_across_slices_take_the_earlier_slice(case):
    """Two equal rows of the book, one in slice 0 and one in slice 3, both
    nearest to every query: the carry takes a later slice only when it is
    strictly smaller, so slice 0's index wins."""
    chunk, r0, r3 = TIES[case]
    x, book = _data(8, 64, 12, seed=1)
    book[r3] = book[r0]
    x = book[r0] + 0.01 * x  # r0 (and r3) nearest to every row
    codes, d = chunked_argmin_plain(x, book, chunk=chunk)
    assert codes.tolist() == [r0] * 8
    want, size = _exact(x, book, codes)
    np.testing.assert_array_less((d.double() - want).abs(), RTOL * size)


# (N, K, D, chunk, max_elems): one slice, ragged slices, row blocks
PARTIAL = {"one_slice": (37, 50, 16, 65536, 2**28), "ragged_slices": (37, 1000, 12, 300, 2**28),
           "row_blocks": (37, 1000, 12, 300, 1500), "one_row": (1, 129, 4, 64, 2**28)}


@pytest.mark.parametrize("case", sorted(PARTIAL))
def test_plain_argmin_partial_distances(case):
    """The codes are a first minimum of ‖c‖² − 2 x·c and the distances its
    value, whatever the slices and row blocks."""
    N, K, D, chunk, max_elems = PARTIAL[case]
    x, book = _data(N, K, D, seed=2)
    codes, d = chunked_argmin_plain(x, book, chunk=chunk, max_elems=max_elems)
    assert codes.dtype == torch.int64 and d.dtype == torch.float32
    assert codes.shape == d.shape == (N,)
    want, size = _exact(x, book, codes)
    np.testing.assert_array_less((d.double() - want).abs(), RTOL * size)
    exact_all = (book.double() ** 2).sum(-1) - 2 * x.double() @ book.double().T
    best = exact_all.min(dim=1).values
    np.testing.assert_array_less(want - best, RTOL * size + 1e-12)


@pytest.mark.parametrize("recording", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_argmin_rows_are_counted_while_recording(recording, dtype):
    """On the CPU every row takes the plain loop, and adds to
    ``distances.plain_argmin_rows`` while recording (and only then);
    ``chunked_argmin`` gives the plain loop's result."""
    x, book = _data(70, 300, 8, seed=3)
    x, book = x.to(getattr(torch, dtype)), book.to(getattr(torch, dtype))
    tracing.clear()
    with tracing.recording() if recording else contextlib.nullcontext():
        got = chunked_argmin(x, book, chunk=128)
    want = chunked_argmin_plain(x, book, chunk=128)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tracing.counters().get("distances.plain_argmin_rows", 0) == (70 if recording else 0)
    tracing.clear()


# (N, K, splits): the encode's chunk on the 2^20 book (8 row blocks: one
# wave of 264 blocks), k-means' 2048-row steps (two waves), a row block for
# a lone row, rows that fill the card alone, a 256-row book
PLANS = {"encode": (1024, 2**20, 33), "kmeans_step": (2048, 2**20, 33),
         "one_row": (1, 2**20, 256), "many_rows": (2**18, 2**20, 1), "rq_book": (32768, 256, 1),
         "ragged": (4096, 65536 + 37, 8)}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_nearest_plan(case):
    """The splits at the card's 132 SMs: within the book's tiles, and the
    blocks within four waves of the resident slots (two blocks an SM)."""
    N, K, want = PLANS[case]
    splits = kernels.nearest_plan(N, K, 132)
    assert splits == want
    tiles, rows = -(-K // 128), -(-N // 128)
    assert 1 <= splits <= tiles
    assert splits == 1 or rows * splits <= 4 * 2 * 132


def test_nearest_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only (the CPU takes the plain loop)."""
    x, book = _data(4, 8, 4, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.nearest(x, book)


# --- the kernel, on the card ------------------------------------------------

DS = (16, 96, 128, 768)
KS = {"256": 256, "64k+37": 65536 + 37, "1M": 2**20}
NS = (1, 1023, 1024, 4096)


def _launches():
    return {k: kernels.LAUNCHES[k] for k in kernels.NEAREST_KERNELS}


def _check_against_plain(x, book, got_i, got_d):
    want_i, want_d = chunked_argmin_plain(x, book)
    assert got_i.dtype == torch.int64 and got_d.dtype == torch.float32
    assert got_i.shape == got_d.shape == (x.shape[0],)
    d_got, size = _exact(x, book, got_i)
    d_want, _ = _exact(x, book, want_i)
    differ = got_i != want_i
    assert ((d_got - d_want).abs()[differ] <= RTOL * size[differ]).all(), "a code differs off a tie"
    assert ((got_d.double() - d_got).abs() <= RTOL * size).all()
    same = ~differ
    assert ((got_d - want_d).abs()[same].double() <= RTOL * size[same]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("K", sorted(KS))
@pytest.mark.parametrize("D", DS)
def test_nearest_kernel_matches_the_plain_loop(cuda, D, K, N):
    """The kernel's codes and partial distances against the plain loop on
    the card (see the tolerances above), one launch and one merge where the
    plan splits the book, and the same bits on a second run."""
    x, book = _data(N, KS[K], D, seed=D + N, device=cuda)
    before = _launches()
    got_i, got_d = chunked_argmin(x, book)
    torch.cuda.synchronize()
    merged = int(kernels.nearest_plan(N, KS[K], torch.cuda.get_device_properties(
        cuda).multi_processor_count) > 1)
    assert _launches() == {"nearest": before["nearest"] + 1,
                           "nearest_merge": before["nearest_merge"] + merged}
    _check_against_plain(x, book, got_i, got_d)
    again_i, again_d = chunked_argmin(x, book)
    assert torch.equal(again_i, got_i)
    assert torch.equal(again_d.view(torch.int32), got_d.view(torch.int32))


# (N, D): duplicates placed across a tile, a split and a slice boundary
TIE_CASES = {"encode": (1024, 128), "one_row": (1, 128), "wide": (1024, 768)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_nearest_kernel_ties_take_the_lowest_index(cuda, case):
    """Copies of one book row at the end of a tile, at the first row of the
    next split, in the plain loop's next 65,536-row slice and in the last
    tile: every query near that row gets its lowest index, as in the plain
    loop."""
    N, D = TIE_CASES[case]
    K = 2**20
    x, book = _data(N, K, D, seed=5, device=cuda)
    splits = kernels.nearest_plan(N, K, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    tiles = -(-K // 128)
    split1 = (tiles // splits) * 128  # the first row of split 1
    rows = [300, 383, split1, split1 + 1, 65536 + 5, K - 1]
    first = min(rows)
    book[rows] = book[first].clone()
    x = book[first] + 0.01 * x
    got_i, _ = chunked_argmin(x, book)
    want_i, _ = chunked_argmin_plain(x, book)
    assert got_i.tolist() == [first] * N
    assert want_i.tolist() == [first] * N


@pytest.mark.cuda
def test_nearest_kernel_counts_no_plain_rows(cuda):
    """While recording, CUDA float32 calls take the kernel and add nothing
    to ``distances.plain_argmin_rows``; float64 calls take the plain loop
    and add their rows."""
    x, book = _data(64, 1000, 16, seed=6, device=cuda)
    tracing.clear()
    with tracing.recording():
        chunked_argmin(x, book)
        assert tracing.counters().get("distances.plain_argmin_rows", 0) == 0
        chunked_argmin(x.double(), book.double())
        assert tracing.counters()["distances.plain_argmin_rows"] == 64
    tracing.clear()


def _clusters(n, K, D, device):
    """Rows near K well-separated centres: each row's nearest centre is its
    own by a margin far beyond any summation order."""
    g = torch.Generator().manual_seed(7)
    cent = 10.0 * torch.randn((K, D), generator=g)
    lab = torch.randint(0, K, (n,), generator=g)
    x = cent[lab] + 0.1 * torch.randn((n, D), generator=g)
    return x.to(device), cent.to(device), lab.to(device)


@pytest.mark.cuda
def test_kmeans_pass_on_the_card_matches_the_plain_loop(cuda, monkeypatch):
    """``kmeans.accumulate_pass`` through the kernel gives the sums and
    counts of the same pass through the plain loop."""
    x, cent, lab = _clusters(20000, 4096, 128, cuda)

    def one_pass():
        sums = torch.zeros_like(cent)
        counts = torch.zeros((len(cent),), dtype=torch.int64, device=cuda)
        kmeans.accumulate_pass(x, cent, sums, counts, chunk=1024, rows=4096)
        return sums, counts

    before = kernels.LAUNCHES["nearest"]
    sums, counts = one_pass()
    assert kernels.LAUNCHES["nearest"] == before + 5
    assert torch.equal(counts, torch.bincount(lab, minlength=len(cent)))
    monkeypatch.setattr(kmeans, "chunked_argmin", chunked_argmin_plain)
    sums_p, counts_p = one_pass()
    assert torch.equal(counts, counts_p) and torch.equal(sums, sums_p)
