"""Check on the card that the port's spans (``qinco_torch.tracing``) and
the profiler's device operations lie on one clock.

    python scripts/torch_trace_clock.py [--repeats 20]

Under one CUDA-only torch profiler session (the device traced alone, as
the benchmark traces its training cell), after a first launch, each
repeat opens a span around ``torch.cuda._sleep`` (a spin kernel of about
half a millisecond) and a synchronization.  The kernel's interval, put on
the host's clock by the session's trace start, must lie inside the span
and start less than 200 µs after it.  Prints one JSON line: the card, the torch version,
whether ``torch.autograd._profiler_enabled()`` and the profiler's Python
flag read true under that session, and per repeat where the kernel lay
(µs after the span's start and after the launch returned; the span's
length); exits with 1 if a repeat fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from qinco_torch import tracing  # noqa: E402

SPIN_CYCLES = 10**6
NAME = "clock.check"
LAUNCHED = "clock.launched"


def check(repeats: int = 20) -> list[dict]:
    """One CUDA-only profiler session: a first launch, then ``repeats``
    spans, each around a spin kernel's launch and a synchronization, with
    a child span opened as the launch returns.  Per repeat: the spin
    kernel's start after the span's start and after the launch returned,
    its end before the span's end (µs), the span's length, and whether
    the kernel lay inside the span."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flags = (bool(torch.autograd._profiler_enabled()),
                 bool(torch.autograd.profiler._is_profiler_enabled))
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(repeats):
            with tracing.span(NAME):
                torch.cuda._sleep(SPIN_CYCLES)
                with tracing.span(LAUNCHED):
                    pass
                torch.cuda.synchronize()
    start = tracing.profiler_trace_starts()[-1]
    spans = [s for s in tracing.spans() if s.name == NAME]
    launched = {s.parent: s for s in tracing.spans() if s.name == LAUNCHED}
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and "spin_kernel" in e.name), key=lambda e: e.time_range.start)[1:]
    out = []
    for s, k in zip(spans, kernels):
        a = start + k.time_range.start * 1000
        b = start + k.time_range.end * 1000
        out.append({"profiler_enabled": flags[0], "python_flag": flags[1],
                    "start_after_us": (a - s.start_ns) / 1e3,
                    "start_after_launch_us": (a - launched[s.id].start_ns) / 1e3,
                    "end_before_us": (s.end_ns - b) / 1e3,
                    "span_us": (s.end_ns - s.start_ns) / 1e3,
                    "kernel_us": (b - a) / 1e3,
                    "inside": s.start_ns <= a and b <= s.end_ns})
    if len(out) != repeats:
        raise RuntimeError(f"{len(kernels)} spin kernels for {repeats} spans")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeats", type=int, default=20)
    args = p.parse_args()
    rows = check(args.repeats)
    after = [r["start_after_us"] for r in rows]
    after_launch = [r["start_after_launch_us"] for r in rows]
    ok = all(r["inside"] and 0 <= r["start_after_us"] < 200 for r in rows)
    print(json.dumps({"clock_check": {
        "card": torch.cuda.get_device_name(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "ok": ok,
        "profiler_enabled": [r["profiler_enabled"] for r in rows],
        "python_flag": [r["python_flag"] for r in rows],
        "start_after_us": {"min": min(after), "median": statistics.median(after),
                           "max": max(after)},
        "start_after_launch_us": {"min": min(after_launch),
                                  "median": statistics.median(after_launch),
                                  "max": max(after_launch)},
        "end_before_us": {"min": min(r["end_before_us"] for r in rows),
                          "max": max(r["end_before_us"] for r in rows)},
        "repeats": rows}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
