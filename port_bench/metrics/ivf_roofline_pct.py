"""``ivf_roofline_pct``: the IVF step 0, ``ops.distances.chunked_argmin``:
the least time of a chunk's step by ``work.ivf_work`` against the peak of
the precision its product runs in (f32 on the CUDA cores while
``torch.backends.cuda.matmul.allow_tf32`` is False, TF32 otherwise, read
at run time), over the device time of the operations that the step's
calls launched (the benchmark's span around each call), a chunk."""

import work

SPAN = "bench.ivf_step0"


def read(obs):
    if obs["kind"] != "encode" or obs["trace"] is None:
        return None
    spans, seconds = obs["trace"].span_device_s(SPAN)
    if spans == 0 or seconds <= 0:
        return None
    bound = work.bound_ms(*work.ivf_work(obs["work"], obs["batch"]),
                          "tf32" if obs["tf32"] else "float32")[0]
    return 100.0 * (bound / 1e3) / (seconds / spans)
