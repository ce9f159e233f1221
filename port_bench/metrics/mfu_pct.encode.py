"""``mfu_pct.encode``: the encode's FLOPs a vector (``work.encode_flops``:
the IVF product, then each MLP step's selected scores and select-rebuild)
times the vectors a second of the traced run's window, over the H100's
dense bf16 peak."""

import work


def read(obs):
    if obs["kind"] != "encode":
        return None
    flops = work.encode_flops(obs["work"], 1)
    return 100.0 * flops * obs["rate"] / work.PEAK_FLOPS["bfloat16"]
