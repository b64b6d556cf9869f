"""The import guard: no file the benchmark runs imports JAX, flax, optax
or the JAX package (top-level names compared whole: the port's name
begins with the JAX package's), and the plain reference imports nothing
of the program."""
import ast
import subprocess
import sys

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "segger_tpu"}


def imported(path):
    """Top-level names of every module a file imports, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def run_files():
    return [p for p in BENCH.rglob("*.py")
            if "tests" not in p.relative_to(BENCH).parts]


def test_no_file_the_benchmark_runs_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): imported(p) & FORBIDDEN
             for p in run_files()}
    assert not any(found.values()), found
    # the program's own name passes: compared whole, it is not the JAX
    # package's
    assert "segger_tpu_torch" in imported(BENCH / "harness.py")


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "references").glob("*.py"):
        assert not {n for n in imported(p)
                    if n.startswith("segger")}, p


def test_the_programs_import_tree_holds_no_jax():
    """The modules the harness loads, imported in a fresh process: no
    module whose top-level name is forbidden comes along."""
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(REPO)!r}]; "
            "import harness, compare, counts, tracing, generator; "
            "harness._port(); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
