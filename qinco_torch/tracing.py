"""Spans and counters that the port records about its own host work, on
the clock of the torch profiler's events.

A span is a named stretch of the host's time: ``with span(name, **ids):``
(``as s``, then ``s.set(**ids)`` adds ids found inside it).
Spans nest; each record holds its name, start and end (``time.time_ns()``),
its own id, its parent's id (the span open when it started, 0 for none)
and its integer ids.  The request ids (:data:`REQUEST_IDS`: ``chunk``,
``step``) of the parent are carried down, so that the spans of one chunk
or one train step share the chunk's or the step's id.  Spans nest as one
host thread opens them: the port's loops record from one thread.

Recording is on while a torch profiler session is active (the profiler's
own Python flag, ``torch.autograd.profiler._is_profiler_enabled``, which
every session sets, a CUDA-only one too) or inside :func:`recording`;
otherwise :func:`span` costs a flag check and returns the shared no-op
:data:`NOOP`, and :func:`count` does nothing.  Records
stay in memory (at most :data:`CAP` spans; more are counted under
``tracing.dropped``) until :func:`clear`; :func:`spans` and
:func:`counters` read them.

The clock: the profiler's events lie, in µs, after the trace's start,
``trace_start_ns()`` of its results, which is on ``time.time_ns()``'s
clock.  The module wraps the profiler's ``_disable_profiler`` so that each
session's start is kept as it ends (:func:`profiler_trace_starts`); a
span at ``t`` ns lies at ``(t - start) / 1000`` µs in that session's
trace.

The spans, by layer (each name is fixed):

- ``models.qinco.encode_chunked``: ``encode.chunk`` (ids ``chunk``,
  ``rows``, ``pad_rows``), one a chunk, holding ``encode.upload`` (the
  slice's copy, zero pad, pin and H2D enqueue),
  ``encode.download`` (the codes' D2H enqueue and event record) and
  ``encode.wait`` (the host waiting on the device for a chunk's codes; its
  ``chunk`` is the chunk waited for, which is the one before, or the
  chunk itself for the last).
- ``models.qinco.encode`` / ``encode_from_coarse``: ``encode.ivf`` (the
  IVF step 0, ``chunked_argmin``), ``encode.step`` (id ``step_i``, each
  MLP beam step) and ``encode.backtrace``.
- ``ops.kernels``: ``kernels.selected_scores``, ``kernels.select_rebuild``,
  ``kernels.fused_substep_scores`` and ``kernels.candidate_scores`` around
  each wrapper's CUDA path: its weight operands (the casts), its launch
  plan and the launch; ``kernels.selected_scores`` has the plan's ids
  ``tile_pairs`` (pairs a tile) and ``cluster`` (blocks that share each
  weight slab); ``kernels.selected_scores`` and ``kernels.select_rebuild``
  have ``d_passes`` (the plan's column passes over the data's width D: 1
  where it holds D whole) and ``refetch_bytes`` (the bytes those passes
  read again beyond the first read, worked out from the plan and not
  observed: ``kernels.selected_refetch_bytes``,
  ``kernels.rebuild_refetch_bytes``; 0 on one pass).
- ``train.train_step.make_train_step``: ``train.step`` (id ``step``, the
  step object's count), holding ``train.encode``, ``train.losses``,
  ``train.backward`` (``torch.autograd.grad``), ``train.stats`` (EMA and
  usage), ``train.clip`` (the reduce, the division and the clamp into
  ``.grad``) and ``train.optimizer`` (``opt.step()`` and ``zero_grad``).
- ``utils.host_to_device``: ``io.upload`` (id ``bytes``).

Counters: ``io.h2d_bytes``, the bytes copied host to device by
``encode.upload`` and ``io.upload``, while recording;
``kernels.weight_stream_bytes``, the weight bytes each bf16
``selected_scores`` launch's plan streams from L2 (its tiles' and items'
products, once a cluster: ``kernels.selected_stream_bytes``), while
recording; ``kernels.refetch_bytes``, the sum of the two spans'
``refetch_bytes``, while recording; ``distances.plain_argmin_rows``, the rows that
``ops.distances.chunked_argmin`` gives its plain loop (not CUDA float32:
the CPU, other types), while recording; and
:data:`LAUNCHES`, the kernel launches by kernel (``ops.kernels``), always
on and never cleared (its readers take differences): the beam step's
kernels by wrapper name, the IVF step's ``nearest`` and its merge
``nearest_merge`` (a call launches the one, and the other where the book
is split), the breakdown kernels by wrapper and cut.  Where every IVF
step took the kernel, ``nearest`` counts the calls and
``distances.plain_argmin_rows`` reads 0.

The benchmark (``port_bench/progspans.py``) reads ``encode.chunk``,
``encode.wait``, ``kernels.*`` (with their ``refetch_bytes``),
``train.step`` and ``train.encode``;
``eval_time`` with ``profile_dir`` writes every span and counter beside
its profiler trace (:func:`export`).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import NamedTuple

from torch.autograd import profiler as _profiler

CAP = 1 << 20
REQUEST_IDS = ("chunk", "step")

# Kernel launches by kernel name, always counted (``ops.kernels`` names
# its kernels here and counts each launch).
LAUNCHES: dict[str, int] = {}


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int  # 0: none
    ids: dict


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **ids: int) -> None:
        pass


NOOP = _Noop()

_depth = 0  # open recording() contexts
_spans: list[Span] = []
_counts: dict[str, int] = {}
_stack: list["_Open"] = []
_next_id = 1
_trace_starts: list[int] = []


def _on() -> bool:
    return _depth > 0 or _profiler._is_profiler_enabled


class _Open:
    __slots__ = ("name", "ids", "id", "parent", "start_ns")

    def __init__(self, name: str, ids: dict):
        global _next_id
        parent = _stack[-1] if _stack else None
        self.name = name
        if parent is not None:
            ids = {**{k: parent.ids[k] for k in REQUEST_IDS if k in parent.ids}, **ids}
        self.ids = ids
        self.parent = parent.id if parent is not None else 0
        self.id = _next_id
        _next_id += 1

    def __enter__(self):
        _stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def set(self, **ids: int) -> None:
        """Add ``ids`` to the open span (ids known only inside it)."""
        self.ids = {**self.ids, **ids}

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack.pop()
        if len(_spans) < CAP:
            _spans.append(Span(self.name, self.start_ns, end, self.id, self.parent, self.ids))
        else:
            _counts["tracing.dropped"] = _counts.get("tracing.dropped", 0) + 1
        return False


def span(name: str, **ids: int):
    """A context manager that records the span ``name`` with ``ids`` while
    recording is on; :data:`NOOP` otherwise."""
    if not _on():
        return NOOP
    return _Open(name, ids)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if _on():
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, profiler or not."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def spans() -> list[Span]:
    """The spans recorded since the last :func:`clear`, by start."""
    return sorted(_spans, key=lambda s: s.start_ns)


def counters() -> dict[str, int]:
    """The counters recorded since the last :func:`clear`, and the kernel
    launches since the process started (``launch.<kernel>``)."""
    return {**_counts, **{f"launch.{k}": v for k, v in LAUNCHES.items()}}


def clear() -> None:
    """Forget the recorded spans and counters (not :data:`LAUNCHES`)."""
    _spans.clear()
    _counts.clear()


def profiler_trace_starts() -> list[int]:
    """``trace_start_ns()`` of each torch profiler session that has ended
    in this process, in order."""
    return list(_trace_starts)


def _keep_trace_start(disable):
    def disable_profiler(*args, **kwargs):
        result = disable(*args, **kwargs)
        start = getattr(result, "trace_start_ns", None)
        if start is not None:
            _trace_starts.append(int(start()))
        return result

    disable_profiler.wrapped = disable
    return disable_profiler


if not hasattr(_profiler._disable_profiler, "wrapped"):
    _profiler._disable_profiler = _keep_trace_start(_profiler._disable_profiler)


def export(path) -> None:
    """Write the recorded spans and counters to ``path`` as a Chrome trace:
    ``traceEvents`` in µs after the last profiler session's start, so that
    the file lines up with that session's trace, and the counters under
    ``otherData``."""
    trace_start_ns = _trace_starts[-1] if _trace_starts else 0
    events = [{"name": s.name, "ph": "X", "pid": "qinco_torch spans", "tid": 0,
               "ts": (s.start_ns - trace_start_ns) / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"id": s.id, "parent": s.parent, **s.ids}} for s in spans()]
    Path(path).write_text(json.dumps({
        "traceEvents": events, "displayTimeUnit": "ms",
        "otherData": {"trace_start_ns": trace_start_ns, "clock": "time.time_ns",
                      "counters": counters()}}))
