"""``b3_roofline_pct``: B3, ``ops.kernels.select_rebuild``
(``csrc/select_rebuild.cu``): the least time of a launch by
``work.rebuild_work`` at each MLP step's launch shapes, over the mean
device time of a launch in the traced stretch."""

import work

KERNEL = "select_rebuild"


def read(obs):
    if obs["kind"] != "encode" or obs["trace"] is None:
        return None
    spec, N = obs["work"], obs["batch"]
    count, seconds = obs["trace"].kernels(KERNEL)
    if count == 0:
        return None
    bounds = [work.bound_ms(*work.rebuild_work(spec, N, F_in, A, spec.B, 2), "bfloat16")[0]
              for F_in, A in work.encode_launches(spec)]
    return 100.0 * (sum(bounds) / len(bounds) / 1e3) / (seconds / count)
