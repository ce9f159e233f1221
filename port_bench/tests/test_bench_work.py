"""``work.py``'s counts against counts made by hand at qinco2-S and -L."""

import common
import work


def spec(name):
    return work.work_spec(common.load_json(common.BENCH / "configs" / f"{name}.json"))


def test_qinco2_s_encode_flops_by_hand():
    s = spec("qinco2-S")
    ivf = 2 * 2 ** 20 * 128  # the product with the whole IVF book
    slot = 2 * 128 * 128 + 2 * 2 * (2 * 128 * 256) + 3 * 128  # fetch, 2 FFN blocks, distance
    head = 2 * 256 * 128 + 2 * 128 * 128  # substep distances, condition product
    b2_first = head + 32 * slot  # one beam row, max(A, B) = 32 candidates
    b2_rest = 32 * (head + 16 * slot)  # 32 beam rows, A = 16
    b3 = 32 * (2 * 256 * 128 + 2 * 2 * (2 * 128 * 256))  # the MLP for the 32 kept
    assert b2_first == 9_547_776 and b2_rest == 154_337_280 and b3 == 10_485_760
    assert work.encode_flops(s, 1) == ivf + b2_first + b3 + 7 * (b2_rest + b3) == 1_442_230_272
    assert work.selected_work(s, 1024, 1, 32, 2)[0] == 1024 * b2_first
    assert work.rebuild_work(s, 1024, 32, 16, 32, 2)[0] == 1024 * b3


def test_qinco2_l_encode_flops_by_hand():
    s = spec("qinco2-L")
    ivf = 2 * 2 ** 20 * 128
    ffn = 16 * 2 * (2 * 384 * 384)
    slot = 2 * 128 * 384 + ffn + 2 * 384 * 128 + 3 * 128  # fetch, 16 blocks, out_proj, distance
    head = 2 * 256 * 128 + 2 * 128 * 384
    chain = 2 * (2 * 128 * 384) + 2 * (384 + 128) * 384 + ffn  # in/out proj, concat, blocks
    b2_first, b2_rest, b3 = head + 32 * slot, 32 * (head + 16 * slot), 32 * chain
    assert b2_first == 308_457_472 and b2_rest == 4_937_940_992 and b3 == 320_864_256
    assert work.encode_flops(s, 1) == ivf + b2_first + b3 + 7 * (b2_rest + b3) == 37_709_393_920


def test_ivf_work_and_bound():
    s = spec("qinco2-S")
    flops, nbytes = work.ivf_work(s, 1024)
    assert flops == 2 * 1024 * 2 ** 20 * 128
    assert nbytes == 4 * (1024 * 128 + 2 ** 20 * 128) + 8 * 1024
    ms, by = work.bound_ms(flops, nbytes, "float32")
    assert by == "operations" and abs(ms - flops / 67e12 * 1e3) < 1e-12


def test_train_flops_add_the_losses_to_the_encode():
    s = spec("qinco2-S")
    chain = 2 * 256 * 128 + 2 * 2 * (2 * 128 * 256)
    assert work.train_flops(s, 1024) - work.encode_flops(s, 1024) == 3 * 1024 * 8 * (
        chain + 6 * 128)
