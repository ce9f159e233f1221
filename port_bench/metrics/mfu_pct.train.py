"""``mfu_pct.train``: a training step's FLOPs a row (``work.train_flops``:
the encode, the losses' forward and backward) times the rows a second of
the traced run's window, over the H100's dense bf16 peak."""

import work


def read(obs):
    if obs["kind"] != "train":
        return None
    flops = work.train_flops(obs["work"], 1)
    return 100.0 * flops * obs["rate"] / work.PEAK_FLOPS["bfloat16"]
