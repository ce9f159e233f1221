"""No module whose top-level name is JAX's or the JAX package's is loaded
by a run, and the reference loads nothing of the program."""

import subprocess
import sys

from conftest import BENCH

DRY = f"""
import sys, torch
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
sys.path.insert(0, {str(BENCH / 'tests')!r})
import conftest, run, common, tempfile, pathlib, json, io, contextlib
root = conftest.copy_bench(pathlib.Path(tempfile.mkdtemp()))
conftest.add_tiny_cells(root)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = run.main(["--workload", "tiny.{{kind}}", "--seed", "5", "--seconds", "0.5"],
                  device=torch.device("cpu"), root=root, bench=root / "port_bench")
assert rc == 0 and json.loads(out.getvalue().splitlines()[-1])["correct"] is not None
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    for kind in ("encode", "train"):
        loaded = top_level_after(DRY.replace("{kind}", kind))
        assert not loaded & {"jax", "jaxlib", "flax", "qinco_tpu"}
        assert "qinco_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\n"
            "import checks, gen, work, devtrace, harness\n"
            "from reference import qinco_ref, lowp\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = top_level_after(code)
    assert not loaded & {"qinco_torch", "jax", "jaxlib", "flax", "qinco_tpu"}
