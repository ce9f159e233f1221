"""Run one cell of the benchmark of ``qinco_torch`` once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration, traffic mix, limits and per-layer
metrics are files found by name (``common.py``).  The run makes its
weights and data from ``--seed``, warms up (set-up), measures for
``--seconds``, checks what the window produced against the plain
reference, and prints one JSON line last: ``--trace 0`` the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics.  Without a CUDA
card, or with fewer than the cell asks for, it prints no result and exits
with 3.  If JAX or the JAX package is loaded once the window has closed,
it names them on stderr and exits with 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Build and kernel caches at fixed paths inside the checkout.
os.environ.setdefault("QINCO_TORCH_BUILD_DIR", str(ROOT / "build" / "qinco_torch_kernels"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "port_bench" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "port_bench" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]

import torch  # noqa: E402

import common  # noqa: E402


class Ctx:
    """What a driver gets: the cell's files, the run's arguments and device."""

    def __init__(self, cell, args, device, t_start):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.device, self.t_start = device, t_start
        self.marks = {}

    def mark(self, name: str) -> None:
        """Note the seconds since the start at the end of a set-up phase."""
        self.marks[name] = self.elapsed()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def free(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(cell, obs) -> dict:
    out = {}
    for m in cell.per_layer():
        value = common.metric_reader(m["name"], cell.bench)(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(cell, res, device, trace: bool) -> dict:
    """The result line; ``checks`` comes last."""
    checks = common.compare(res["readings"], cell.limits["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        tr = res["window"].trace
        metrics = per_layer(cell, res["obs"])
        dev.update(busy_s=tr.busy_s(), window_s=tr.wall_s)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end()}
        values = dict(res["e2e"], setup_s=res["setup_s"])
        metrics = {k: {"value": values[k], "unit": units[k]} for k in units}
    line = {"correct": all(c["ok"] for c in checks.values()), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line


def run_cell(cell, args, device, t_start) -> tuple[dict, dict]:
    """The driver's run of the cell and its result line."""
    ctx = Ctx(cell, args, device, t_start)
    ctx.mark("imports")
    res = cell.driver().run(ctx)
    res["marks"] = ctx.marks
    return result(cell, res, device, ctx.trace), res


def main(argv=None, device=None, root=ROOT, bench=BENCH, t_start=T_START) -> int:
    """One run; ``device`` given (the tests' CPU) skips the look for a card,
    ``root`` and ``bench`` (the tests' copies) hold the manifest and the
    cell's files."""
    args = parse(argv)
    cell = common.Cell(common.load_manifest(root), args.workload, bench)
    if device is None:
        need = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"needs {need} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    line, res = run_cell(cell, args, device, t_start)
    found = common.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    info = {"card": common.card(device), "calls": res["window"].calls,
            "trace_read_s": res["window"].trace_read_s, "setup_marks": res["marks"],
            "readings": res["readings"]}
    st = res["window"].stamps
    if len(st) >= 10:  # the host's seconds of each fifth of the window's calls
        cut = [round(i * (len(st) - 1) / 5) for i in range(6)]
        info["fifths_s"] = [st[b] - st[a] for a, b in zip(cut, cut[1:])]
    print(json.dumps(info), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
