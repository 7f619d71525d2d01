"""What the benchmark imports: after a CPU pass through a serving and a
training run, no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``vanerf_tpu`` is loaded (compared by the whole part before
the first dot: the program's ``vanerf_tpu_torch`` begins with the JAX
package's name), and the reference and the model families (the reference
side of each configuration) import nothing of the program."""

import ast
import pathlib
import subprocess
import sys

from benchmark.tests.tiny import tiny_copy

ROOT = pathlib.Path(__file__).resolve().parents[1]
DRIVE = """
import sys, time
sys.path.insert(0, {root!r})
from benchmark.manifest import Manifest
from benchmark.run import execute, forbidden_modules
mf = Manifest({path!r}, root={bench!r})
for cell in ("tiny-serve", "tiny-train"):
    execute(mf, cell, 2 ** 40 + 1, 0.01, False, "cpu", time.perf_counter())
assert "vanerf_tpu_torch" in sys.modules
print("FORBIDDEN", forbidden_modules())
"""


def test_a_run_loads_no_jax(tmp_path):
    path = tiny_copy(tmp_path)
    code = DRIVE.format(root=str(ROOT.parent), path=str(path),
                        bench=str(tmp_path / "benchmark"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=1200, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for path in [*(ROOT / "reference").glob("*.py"),
                 *(ROOT / "families").glob("*.py")]:
        assert not _imports(path) & {"vanerf_tpu_torch", "vanerf_tpu", "jax",
                                     "jaxlib", "flax"}, path


def test_no_benchmark_file_imports_jax():
    for path in ROOT.rglob("*.py"):
        assert not _imports(path) & {"vanerf_tpu", "jax", "jaxlib",
                                     "flax"}, path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from benchmark.run import forbidden_modules
    monkeypatch.setitem(sys.modules, "vanerf_tpu_torch.fake", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert forbidden_modules() == ["jaxlib"]
