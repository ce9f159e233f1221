"""What every run shares: the manifest and the files it names, the card,
the check for JAX in the process, and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``'s ``workloads``, its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``
(whose ``kind`` names ``drivers/<kind>.py``), the limits of its
comparison in ``limits/<cell>.json``, and each per-layer metric's reader
in ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qinco_tpu")


class Cell:
    """One entry of ``workloads`` with the files it names."""

    def __init__(self, manifest: dict, name: str, bench: Path = BENCH):
        by_name = {w["name"]: w for w in manifest["workloads"]}
        if name not in by_name:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
        self.entry = by_name[name]
        self.name = name
        self.manifest = manifest
        self.config = load_json(bench / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(bench / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{name}.json")
        self.bench = bench

    def end_to_end(self) -> list[dict]:
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        return [m for m in self.manifest["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def driver(self):
        return load_module(self.bench / "drivers" / f"{self.traffic['kind']}.py")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: Path):
    """A module of the benchmark's by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"port_bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH):
    return load_module(bench / "metrics" / f"{name}.py").read


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name, compared
    whole, is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card(device) -> dict:
    """The device a result was measured on: the card's name and power limit
    (``nvidia-smi``) on a card, ``cpu`` otherwise.  (A frozen copy of
    ``scripts/torch_timing.py``'s ``card`` at commit 3513fb6.)"""
    if device.type != "cuda":
        return {"name": "cpu"}
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    name, limit = (f.strip() for f in line.split(","))
    return {"name": name, "power_limit": limit}


def compare(readings: dict, limits: dict) -> dict:
    """Each number compared beside its limit: ``{name: {"value", "limit",
    "ok"}}``; a number is within its limit when it is finite and at most
    the limit."""
    out = {}
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and value == value and abs(value) != float("inf") and (
            value <= limit)
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out
