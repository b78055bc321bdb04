"""No run holds JAX or the JAX package, compared by whole top-level names (the
port's name begins with the JAX package's), and the reference imports
nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from slambench import run

BENCH = Path(__file__).resolve().parents[1]


def test_names_are_compared_whole():
    assert run.forbidden_modules(["vo_slam_test_tpu_torch", "vo_slam_test_tpu_torch.ops",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["vo_slam_test_tpu.lie", "jax._src", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "vo_slam_test_tpu"]


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_the_reference_imports_nothing_of_the_program():
    for f in ("reference.py", "scene.py"):
        got = _imports(BENCH / f)
        assert got <= {"__future__", "dataclasses", "os", "typing", "numpy", "torch"}, (f, got)


def test_no_harness_file_imports_jax():
    for f in list(BENCH.glob("*.py")) + list(BENCH.glob("metrics/*.py")):
        assert not set(run.forbidden_modules(_imports(f))), f


def test_a_process_that_loads_the_whole_harness_and_the_port_holds_no_jax():
    code = ("import sys; from slambench import run, kernels, readings, reference, scene; "
            "import vo_slam_test_tpu_torch.pipeline.system, vo_slam_test_tpu_torch.bench; "
            "print(run.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=BENCH.parent, check=True, timeout=300)
    assert out.stdout.strip() == "[]"
