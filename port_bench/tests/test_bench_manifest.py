"""``BENCHMARK.json`` against the benchmark's contract, every file it
names found by name, and a cell added by new files alone."""

import hashlib
import json
import re

import yaml

import common
from conftest import BENCH, copy_bench, run_cpu

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
M = common.load_manifest()


def test_keys_names_and_units():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["paths"] == ["port_bench"] and M["command"][1].startswith("port_bench/")
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert len(w["why"]) <= 200
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    for group in ("configs", "workloads"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"] for m in M["end_to_end"]}
    for w in M["workloads"]:
        cell = common.Cell(M, w["name"])
        own = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in own and len(own) >= 2
        assert cell.per_layer()
        for m in cell.per_layer():
            assert m["moves"] in e2e - {"setup_s"} and m["moves"] in own, (w["name"], m)


def test_every_file_is_found_by_name():
    for w in M["workloads"]:
        cell = common.Cell(M, w["name"])
        assert callable(cell.driver().run)
        assert set(cell.limits["limits"]) and all(v > 0 for v in cell.limits["limits"].values())
    for m in M["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


def test_configs_hold_the_presets():
    """Every number of the published preset (the program's copy of the
    reference's yaml) and of the training defaults, as the file runs it;
    a key that differs is listed in ``reduced``."""
    root = BENCH.parent / "qinco_torch" / "configs"
    defaults = yaml.safe_load((root / "default.yaml").read_text())
    for c in M["configs"]:
        cfg = common.load_json(BENCH.parent / c["file"])
        preset = yaml.safe_load((root / "model_args" / f"{c['name']}.yaml").read_text())
        want = {**{k: defaults[k] for k in ("batch", "optimizer", "lr", "wd", "grad_clip")},
                **preset}
        assert {k: cfg[k] for k in want} == want
        assert set(c["reduced"]) == {"db_rows"} and cfg["db_rows"] < cfg["published"]["db_rows"]


def test_run_seconds_fits_the_full_check():
    rs = M["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "port_bench").rglob("*") if p.is_file()}


def test_a_cell_is_added_by_new_files_alone(tmp_path, capsys):
    from conftest import add_tiny_cells

    root = copy_bench(tmp_path)
    before = digests(root)
    add_tiny_cells(root)
    after = digests(root)
    assert all(after[p] == d for p, d in before.items())  # no file of the benchmark edited
    new = json.loads((root / "BENCHMARK.json").read_text())
    assert [w for w in new["workloads"] if w["name"] in {x["name"] for x in M["workloads"]}] == (
        M["workloads"])
    rc, line = run_cpu(root, capsys, "--workload", "tiny.encode", "--seed", "9", "--seconds", "1")
    assert rc == 0 and line["correct"]
    assert set(line["metrics"]) == {"encode_vec_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
