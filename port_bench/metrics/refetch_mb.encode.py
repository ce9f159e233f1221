"""``refetch_mb.encode``: the megabytes a chunk that the kernels of
``ops.kernels`` read again for their column passes over the data's width
D: the ``refetch_bytes`` ids of the program's spans ``kernels.*`` inside
the traced stretch's ``encode.chunk`` spans, summed and divided by the
chunks' count (``progspans.py``).  The number is modelled from the
launch plans, not observed: each span's ``refetch_bytes`` is the plan's
arithmetic (``kernels.selected_refetch_bytes``,
``kernels.rebuild_refetch_bytes``), so it reads the same on every run of
a shape and moves only when a plan changes.  ``None`` where the spans
carry no such id (a program without the column passes) or the program
records no spans."""

import progspans


def read(obs):
    if obs["kind"] != "encode":
        return None
    st = progspans.Stretch.of(obs["trace"])
    chunks = st.top("encode.chunk") if st else []
    spans = [s for c in chunks for s in st.descendants(c) if s.name.startswith("kernels.")]
    if not any("refetch_bytes" in s.ids for s in spans):
        return None
    return sum(s.ids.get("refetch_bytes", 0) for s in spans) / 1e6 / len(chunks)
