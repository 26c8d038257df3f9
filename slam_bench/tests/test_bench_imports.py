"""What the benchmark loads: nothing it runs imports JAX or the JAX
package, and the references import nothing of the system under test. Top
level module names are compared whole (the port's name begins with the JAX
package's)."""
import ast
import subprocess
import sys

from slam_bench import run

from .conftest import ROOT

BENCH = ROOT / "slam_bench"
PORT = "orbslam_jpminipc_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_harness_module_imports_jax():
    for p in harness_files():
        bad = top_level_imports(p) & set(run.FORBIDDEN)
        assert not bad, f"{p} imports {bad}"


def test_the_references_import_nothing_of_the_port():
    for p in (BENCH / "reference").rglob("*.py"):
        assert PORT not in top_level_imports(p), p
    code = ("import sys; import slam_bench.reference.extract, slam_bench.reference.ba, slam_bench.reference.pose, "
            "slam_bench.reference.trajectory, slam_bench.check; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in ({PORT!r},) + {run.FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"


def test_a_run_leaves_no_jax_loaded(sound_run):
    assert run.forbidden_modules() == []
