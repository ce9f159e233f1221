"""The device's idle time in a traced run, by what the program was doing.

    python3 port_bench/idle_by_span.py --workload <cell> --seed <n> --seconds <s>

Runs the cell once with ``--trace 1`` as the benchmark does, then puts
each idle gap of the traced stretch (``progspans.gaps``) down to the
innermost of the program's spans (``qinco_torch.tracing``) under way at
the gap's middle, on the trace's clock (``progspans.py``), and prints
one JSON line: the stretch's wall and busy seconds, and per span name
the idle seconds and the number of gaps, largest first (``outside``:
no span under way).  The benchmark's own runs never run this.
"""

import bisect
import json
import sys
import time
from collections import defaultdict

T_START = time.perf_counter()

import run  # noqa: E402  (sets up the paths and the caches as a run does)

import torch  # noqa: E402

import common  # noqa: E402
import progspans  # noqa: E402


def idle_by_span(trace) -> dict:
    st = progspans.Stretch.of(trace)
    if st is None:
        return {}
    spans = sorted((st.us(s.start_ns), st.us(s.end_ns), depth, s.name)
                   for top in st.kids[0] for depth, s in _walk(st, top, 0)
                   if st.us(s.end_ns) > trace.t0 and st.us(s.start_ns) < trace.t1)
    starts = [a for a, *_ in spans]
    out = defaultdict(lambda: [0.0, 0])
    for a, b in progspans.gaps(trace):
        mid = (a + b) / 2
        under = [s for s in spans[:bisect.bisect_right(starts, mid)] if s[1] >= mid]
        name = max(under, key=lambda s: s[2])[3] if under else "outside"
        out[name][0] += (b - a) / 1e6
        out[name][1] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def _walk(st, span, depth):
    yield depth, span
    for s in st.kids[span.id]:
        yield from _walk(st, s, depth + 1)


def main(argv=None) -> int:
    args = run.parse((argv or sys.argv[1:]) + ["--trace", "1"])
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = common.Cell(common.load_manifest(run.ROOT), args.workload, run.BENCH)
    line, res = run.run_cell(cell, args, torch.device("cuda", 0), T_START)
    tr = res["window"].trace
    print(json.dumps({"workload": args.workload, "correct": line["correct"],
                      "wall_s": tr.wall_s, "busy_s": tr.busy_s(),
                      "idle_by_span": idle_by_span(tr)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
