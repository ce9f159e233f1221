"""The readings that a cell's limits are set from, at the cell's own size.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 3] [--out chiprun_out/calib.jsonl]

In one process: for each of ``--seeds`` a run of the cell as the
benchmark makes it (set-up, a window of ``--seconds`` at the cell's own
load, the check), giving the program's numbers; for each of
``--control-seeds`` the control, the reference in the program's place in
the precision below the configuration's (``reference/lowp.py``), and for
training cells the faults planted in the reference (half of each batch
left out; one step's codes shifted).  Each reading is a JSON line.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time

import run  # noqa: F401  (sets up the paths and the caches as a run does)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import checks  # noqa: E402
import common  # noqa: E402
import gen  # noqa: E402
from reference import lowp, qinco_ref  # noqa: E402

FAULTS = ("half", "code")


def encode_control(cell, seed: int, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    shp = qinco_ref.Shape.of(cfg)
    W = gen.random_weights(shp, seed, device)
    host = gen.synthetic_data(W, shp, cfg["db_rows"], seed, cfg["data_noise"])
    rows = np.sort(np.random.default_rng([seed, 5]).choice(len(host), tr["check_rows"],
                                                           replace=False))
    x = checks.normalized(W, torch.from_numpy(host[rows]).to(device))
    ref = qinco_ref.encode(W, shp, x)
    low = qinco_ref.encode(W, shp, x, lowp.fp8, ivf_tf32=True)
    return {"control": checks.encode_readings(W, shp, x, low, ref)}


def train_control(cell, seed: int, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    shp = qinco_ref.Shape.of(cfg)
    W0 = gen.random_weights(shp, seed, device)
    host = gen.synthetic_data(W0, shp, cfg["db_rows"], seed, cfg["data_noise"])
    order = gen.BatchOrder(seed, len(host), cfg["batch"])
    batches = [torch.from_numpy(host[order.rows(i)]).to(device)
               for i in range(tr["check_steps"])]
    hp = (cfg["lr"], cfg["wd"], cfg["grad_clip"])
    ref = qinco_ref.train_steps(W0, shp, batches, *hp)
    out = {"control": checks.train_readings(
        qinco_ref.train_steps(W0, shp, batches, *hp, q=lowp.fp8, ivf_tf32=True), ref, W0)}
    for fault in FAULTS:
        out[fault] = checks.train_readings(
            qinco_ref.train_steps(W0, shp, batches, *hp, fault=fault), ref, W0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = common.Cell(common.load_manifest(run.ROOT), args.workload, run.BENCH)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(dict(obj, workload=cell.name))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in (int(s) for s in args.seeds.split(",") if s):
        t = time.perf_counter()
        run_args = run.parse(["--workload", cell.name, "--seed", str(seed),
                              "--seconds", str(args.seconds)])
        line, res = run.run_cell(cell, run_args, device, t)
        emit({"seed": seed, "side": "program", "readings": res["readings"],
              "correct": line["correct"], "metrics": line["metrics"],
              "s": time.perf_counter() - t})
    control = encode_control if cell.traffic["kind"] == "db_encode" else train_control
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t = time.perf_counter()
        for side, readings in control(cell, seed, device).items():
            emit({"seed": seed, "side": side, "readings": readings,
                  "s": time.perf_counter() - t})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
