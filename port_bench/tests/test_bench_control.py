"""The control, the reference in the program's place computed in the
precision below the configuration's (fp8 products, the IVF product in
TF32: ``reference/lowp.py``), comes out not correct under each cell's
limits: on the CPU at qinco2-S's widths with a smaller IVF book and host
array, and on the card at each cell's own size on three seeds."""

import json

import pytest
import torch

import calibrate
import common

CELLS = [w["name"] for w in common.load_manifest()["workloads"]]


def fails(cell, readings) -> bool:
    checks = common.compare(readings, cell.limits["limits"])
    return not all(c["ok"] for c in checks.values())


def control(cell, seed, device):
    f = calibrate.encode_control if cell.traffic["kind"] == "db_encode" else (
        calibrate.train_control)
    return f(cell, seed, device)["control"]


@pytest.mark.parametrize("name", ["tiny.encode", "tiny.train"])
def test_the_control_fails_at_the_widths_on_the_cpu(tiny_root, name):
    """At qinco2-S's widths, under qinco2-S's limits (``conftest.py``)."""
    cell = common.Cell(common.load_manifest(tiny_root), name, tiny_root / "port_bench")
    cell.traffic = dict(cell.traffic, check_rows=256)
    assert fails(cell, control(cell, 2400000031, torch.device("cpu")))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = common.Cell(common.load_manifest(), name)
    for seed in (2400000041, 2400000042, 2400000043):
        readings = control(cell, seed, torch.device("cuda", 0))
        assert fails(cell, readings), json.dumps(readings)
