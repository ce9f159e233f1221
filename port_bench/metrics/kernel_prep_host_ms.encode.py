"""``kernel_prep_host_ms.encode``: the host's milliseconds a chunk inside
the kernel wrappers of ``ops.kernels`` (the program's spans
``kernels.*``: the step's weights cast to the compute dtype, the launch
plan, the launch), summed over the traced stretch's chunks and divided
by their count (``progspans.py``)."""

import progspans


def read(obs):
    if obs["kind"] != "encode":
        return None
    st = progspans.Stretch.of(obs["trace"])
    chunks = st.top("encode.chunk") if st else []
    spans = [s for c in chunks for s in st.descendants(c) if s.name.startswith("kernels.")]
    if not spans:
        return None
    return sum(progspans.ms(s) for s in spans) / len(chunks)
