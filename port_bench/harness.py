"""The measured window, the same for every traffic kind.

A window calls ``call()`` (one unit of the mix's work, returning how many
vectors or rows it did) back to back from its start until ``seconds``
have passed; a call started before then runs to its end, and the device
is synchronized before the window's end is read.  The rate is all the
window's work over all its time.

With ``trace``, the window is the same length, but a stretch in its
middle runs under torch.profiler: ``WARM_CALLS`` calls to let the
profiler settle, then ``active_calls`` calls between two
synchronizations, whose trace the per-layer metrics read.  The host's
operations are recorded only where the driver gives ``spans``, the
benchmark's spans around the program's layers (``devtrace.py``).  The
rate of a traced window leaves that stretch out.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import devtrace as bench_trace

WARM_CALLS = 1


@dataclasses.dataclass
class Window:
    n: int  # vectors or rows done outside the traced stretch
    seconds: float  # their time
    calls: int  # calls in the whole window
    plain: list  # indices of the calls outside the traced stretch
    trace: Optional[bench_trace.Trace] = None
    active_n: int = 0  # vectors or rows of the traced stretch's active calls
    trace_read_s: float = 0.0
    stamps: list = dataclasses.field(default_factory=list)  # host clock at each call's return

    @property
    def rate(self) -> float:
        return self.n / self.seconds


def run(call: Callable[[], int], seconds: float, sync: Callable[[], None], trace: bool = False,
        active_calls: int = 1, spans=None) -> Window:
    """The window; ``spans(fn)`` runs ``fn`` with the benchmark's spans
    around the program's layers, in the traced stretch only."""
    idx, stamps = [0], []

    def one() -> int:
        idx[0] += 1
        n = call()
        stamps.append(time.perf_counter())
        return n

    def until(t_end: float) -> tuple[int, float, list]:
        sync()
        t0, n, done = time.perf_counter(), 0, []
        while True:
            done.append(idx[0])
            n += one()
            if time.perf_counter() >= t_end:
                break
        sync()
        return n, time.perf_counter() - t0, done

    start = time.perf_counter()
    if not trace:
        n, s, done = until(start + seconds)
        return Window(n, s, idx[0], done, stamps=stamps)
    n_a, s_a, done_a = until(start + seconds / 3)
    got = [0]

    def active():
        for _ in range(active_calls):
            got[0] += one()

    warm = lambda: [one() for _ in range(WARM_CALLS)]
    if spans is not None:
        tr, read_s = spans(lambda: bench_trace.profiled(warm, active, sync, host=True))
    else:
        tr, read_s = bench_trace.profiled(warm, active, sync, host=False)
    n_b, s_b, done_b = until(max(start + seconds, time.perf_counter() + 1e-3))
    return Window(n_a + n_b, s_a + s_b, idx[0], done_a + done_b, tr, got[0], read_s, stamps)
