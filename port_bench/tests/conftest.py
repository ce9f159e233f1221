"""The benchmark's own tests: ``python -m pytest port_bench/tests -q`` from
the root.  Cases marked ``cuda`` need a card and skip without one."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


import json  # noqa: E402
import shutil  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

# qinco2-S's widths, with a smaller IVF book and host array, so that a
# run on the CPU takes seconds and reads what the card's runs read.
TINY = dict(name="tiny", ivf_K=4096, db_rows=8192, encode_shard_rows=2048)
# cell -> (its traffic, the cell whose limits it takes, the cell whose
# metrics it reports)
TINY_CELLS = {"tiny.encode": ("tiny-db-encode", "qinco2-S.encode-db", "qinco2-S.encode-db"),
              "tiny.train": ("tiny-train", "qinco2-S.train", "qinco2-L.train")}


def add_tiny_cells(root: Path) -> None:
    """Add a small configuration, its two mixes and two cells to the copy
    of the benchmark under ``root``, by new files and manifest entries
    alone; each cell's limits are its qinco2-S counterpart's (the
    qinco2-S training cell is not in the manifest: ``PERF.md`` §7)."""
    bench = root / "port_bench"
    cfg = json.loads((bench / "configs" / "qinco2-S.json").read_text())
    (bench / "configs" / "tiny.json").write_text(json.dumps(dict(cfg, **TINY)))
    enc = json.loads((bench / "traffic" / "db-encode.json").read_text())
    enc.update(warm_rows=1024, check_rows=1024)
    (bench / "traffic" / "tiny-db-encode.json").write_text(json.dumps(enc))
    (bench / "traffic" / "tiny-train.json").write_text(
        (bench / "traffic" / "train.json").read_text())
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append(dict(m["configs"][0], name="tiny", file="port_bench/configs/tiny.json"))
    for name, (traffic, limits, metrics) in TINY_CELLS.items():
        m["workloads"].append({"name": name, "config": "tiny", "traffic": traffic, "chips": 1,
                               "why": "a small cell for the CPU tests"})
        (bench / "limits" / f"{name}.json").write_text(
            (bench / "limits" / f"{limits}.json").read_text())
        for e in m["end_to_end"] + m["per_layer"]:
            if metrics in e.get("workloads", []):
                e["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))


def copy_bench(root: Path) -> Path:
    shutil.copytree(BENCH, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_bench(tmp_path)
    add_tiny_cells(root)
    return root


def run_cpu(root: Path, capsys, *argv) -> tuple[int, dict]:
    """A run of the copy under ``root`` on the CPU: exit code, result line."""
    import run

    rc = run.main(list(argv), device=torch.device("cpu"), root=root,
                  bench=root / "port_bench")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 else None)
