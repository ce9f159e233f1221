"""``tail_host_ms.train``: the host's milliseconds a step in
``train.train_step.make_train_step`` after the step's encode: from the
end of the program's span ``train.encode`` to the end of its
``train.step`` (losses, backward, statistics, clip, optimizer), averaged
over the traced stretch's steps (``progspans.py``)."""

import statistics

import progspans


def read(obs):
    if obs["kind"] != "train":
        return None
    st = progspans.Stretch.of(obs["trace"])
    tails = [(s.end_ns - st.children(s, "train.encode")[-1].end_ns) / 1e6
             for s in (st.top("train.step") if st else []) if st.children(s, "train.encode")]
    return statistics.mean(tails) if tails else None
