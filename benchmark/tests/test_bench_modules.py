"""What a run may load and what the yardstick may import."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import harness

# The benchmark's own yardstick: the references and everything that makes
# inputs, counts work or compares; none may import the program.
YARDSTICK = ["references/__init__.py", "references/generator_be.py",
             "synth.py", "flops.py", "compare.py", "trace.py"]
PROGRAM = ("deepfluids_tpu_torch", "deepfluids_tpu", "jax", "jaxlib", "flax")


def test_foreign_modules_compares_whole_top_level_names():
    assert harness.foreign_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert harness.foreign_modules(["deepfluids_tpu.config"]) == [
        "deepfluids_tpu"]
    assert harness.foreign_modules(["flax", "jaxlib.xla_client"]) == [
        "flax", "jaxlib"]
    assert harness.foreign_modules(["deepfluids_tpu_torch",
                                    "deepfluids_tpu_torch.ops.fd",
                                    "jaxtyping", "flaxen.x"]) == []


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_yardstick_imports_nothing_of_the_program():
    for rel in YARDSTICK:
        found = _imports(os.path.join(harness.DATA, rel)) & set(PROGRAM)
        assert not found, f"{rel} imports {found}"


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(harness.DATA):
        for name in files:
            if name.endswith(".py") and "tests" not in dirpath:
                found = _imports(os.path.join(dirpath, name)) & {
                    "jax", "jaxlib", "flax", "deepfluids_tpu"}
                assert not found, f"{name} imports {found}"


def test_a_run_loads_no_jax(tmp_path):
    # a whole (tiny, CPU) run in a child, then the check a run makes
    code = (
        "import sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import TINY\n"
        "from benchmark import harness\n"
        "harness.run_cell('sweep2d_grid', 3, 0.2, False, device='cpu',"
        " overrides=TINY)\n"
        "print(harness.foreign_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
