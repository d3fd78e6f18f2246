"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port; top-level names compared whole."""

import os
import subprocess
import sys

from benchmark.harness.common import FORBIDDEN, ROOT, forbidden_modules


def _modules_after(code: str) -> set:
    res = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print('\\n'.join(sorted(sys.modules)))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-2000:]
    return {m.split(".")[0] for m in res.stdout.split()}


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["microbeseg_torch.ops", "jaxtyping",
                              "flaxen"]) == []
    assert forbidden_modules(["jax.numpy", "microbeseg_tpu.ops"]) == [
        "jax.numpy", "microbeseg_tpu.ops"]


def test_a_run_loads_no_jax():
    top = _modules_after(
        "import time, torch\n"
        "torch.set_num_threads(2)\n"
        "sys_path = __import__('sys').path\n"
        "sys_path.insert(0, 'benchmark/tests')\n"
        "from conftest import run_tiny\n"
        "run_tiny('dunet-crops256')\n"
        "run_tiny('dunet-mish-gn-train-b4')\n"
        "import benchmark.run, benchmark.control, benchmark.faults\n")
    assert "microbeseg_torch" in top
    assert not top & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    top = _modules_after(
        "import benchmark.reference.unet, benchmark.reference.postprocess\n"
        "import benchmark.reference.infer, benchmark.reference.augment\n"
        "import benchmark.reference.train, benchmark.reference.lowp\n")
    assert not top & set(FORBIDDEN + ("microbeseg_torch",))
