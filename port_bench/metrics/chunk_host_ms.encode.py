"""``chunk_host_ms.encode``: the host's own milliseconds a chunk in
``models.qinco.encode_chunked``: the program's span ``encode.chunk``
less its ``encode.wait`` child (the host waiting on the device), averaged
over the traced stretch's chunks (``progspans.py``)."""

import statistics

import progspans


def read(obs):
    if obs["kind"] != "encode":
        return None
    st = progspans.Stretch.of(obs["trace"])
    chunks = st.top("encode.chunk") if st else []
    if not chunks:
        return None
    return statistics.mean(progspans.ms(c) - sum(progspans.ms(w) for w in
                                                 st.children(c, "encode.wait"))
                           for c in chunks)
