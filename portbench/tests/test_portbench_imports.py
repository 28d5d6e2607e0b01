"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (``aicamera_tpu_torch`` begins with ``aicamera_tpu``),
the reference and the detector families import nothing of the program, and
each family exports what the harness looks up."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "aicamera_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts]


def test_no_file_of_the_benchmark_imports_jax():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (_sources("reference") + _sources("yardstick")
                 + _sources("families")):
        assert "aicamera_tpu_torch" not in set(_imports(path)), path


def test_every_family_exports_what_the_harness_looks_up():
    found = [p for p in _sources("families") if p.name != "__init__.py"]
    assert found
    for path in found:
        tree = ast.parse(path.read_text())
        names = {n.name for n in tree.body
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        assert {"program_kwargs", "make_weights", "Reference",
                "flops"} <= names, path


def test_a_run_holds_no_jax_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests import small\n"
        "from portbench import harness\n"
        "small.run('n540-deepsort-1x8', seconds=1.0)\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_matches_whole_names():
    from portbench import harness
    assert harness.forbidden_modules(
        ["aicamera_tpu_torch", "aicamera_tpu_torch.runtime", "jaxtyping",
         "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(
        ["aicamera_tpu.core", "jax._src", "jaxlib", "flax.linen"]) == \
        ["aicamera_tpu", "flax", "jax", "jaxlib"]
