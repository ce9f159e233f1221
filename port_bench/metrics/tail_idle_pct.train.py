"""``tail_idle_pct.train``: the device's idle share of the traced
stretch's wall (as ``device_idle_pct.train``) counting only the idle
gaps whose middle falls while the host is in a ``train.step`` after its
``train.encode`` ends: the losses, backward, statistics, clip and
optimizer (the program's spans, on the trace's clock: ``progspans.py``)."""

import bisect

import progspans


def read(obs):
    if obs["kind"] != "train":
        return None
    st = progspans.Stretch.of(obs["trace"])
    steps = [s for s in (st.top("train.step") if st else []) if st.children(s, "train.encode")]
    if not steps:
        return None
    tails = sorted((st.us(st.children(s, "train.encode")[-1].end_ns), st.us(s.end_ns))
                   for s in steps)
    starts = [a for a, _ in tails]
    idle = 0.0
    for a, b in progspans.gaps(obs["trace"]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= tails[i][1]:
            idle += b - a
    return 100.0 * idle / 1e6 / obs["trace"].wall_s
