"""qinco_torch command line, the counterpart of ``run_qinco.py``:

    python -m qinco_torch task=train model_args=qinco2-S encode_profile=parity \\
        trainset=<vectors.npy> output=<model.npz>

Any config key takes a dotted ``key=value`` override; ``model_args=``
selects a preset of ``qinco_torch/configs/model_args/`` and
``encode_profile=`` one of the encode bundles.  Tasks: ``train``,
``eval_valset``, ``eval``, ``eval_time``; ``convert`` (a reference
``.pt`` checkpoint to npz); the search pipeline's ``ivf_centroids``,
``encode``, ``build_index``, ``train_pairwise_decoder`` and ``search``;
the QINCo1-era ``encode_codec``, ``decode_codec``, ``search_2stage``,
``train_pq`` and ``eval_pq``.  They run on the CUDA device, or on the CPU
with ``cpu=true``.

On N cards (``train``, ``eval_valset``, ``eval``, ``eval_time``,
``ivf_centroids``, ``encode``; see ``qinco_torch/parallel``):

    python -m torch.distributed.run --nproc_per_node=N -m qinco_torch task=train ...

or the ``QINCO_COORDINATOR``, ``QINCO_NUM_PROCS`` and ``QINCO_PROC_ID``
variables of the JAX package on each host.  After the task, the main rank
prints the count of each kernel's launches in it, where any launched.
"""

import json
import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if any(a in ("-h", "--help") for a in argv):
        print(__doc__)
        return 0
    from qinco_torch.config import load_config
    from qinco_torch.ops.kernels import LAUNCHES
    from qinco_torch.parallel.distributed import maybe_init_distributed, shutdown
    from qinco_torch.tasks import get_task

    cfg = load_config(argv)
    if cfg.task is None:
        raise SystemExit("Please specify a task (train, eval, ...) using 'task=<name>'")
    started = maybe_init_distributed(bool(cfg.cpu))
    try:
        before = dict(LAUNCHES)
        task = get_task(cfg.task)(cfg)
        task.print(f"====================== RUNNING TASK {cfg.task}")
        task.run()
        launched = {k: v - before[k] for k, v in LAUNCHES.items()}
        if any(launched.values()):
            task.print(f"Kernel launches: {json.dumps(launched)}")
        task.print("Task done")
    finally:
        if started:
            shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
