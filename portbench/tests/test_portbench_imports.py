"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference takes nothing of the program."""

import ast
import os
import subprocess
import sys

from portbench.tests import tiny
from portbench import bench


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(bench.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_forbidden_names_are_matched_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla", "flax", "repro", "repro.core",
            "repro_torch", "repro_torch.core", "jaxtyping", "reprox"]
    assert bench.forbidden_modules(mods) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "repro", "repro.core"]


def test_no_source_of_the_benchmark_imports_jax():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        found = bench.forbidden_modules(_imports(path))
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("repro_torch", "portbench"), \
                (path, name)


def test_a_run_loads_no_jax():
    """Every module a run imports, in a fresh interpreter."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import portbench.run, portbench.serving, portbench.judge, "
            "portbench.devtrace, portbench.bench\n"
            "import repro_torch, repro_torch.serve, repro_torch.checkpoint\n"
            "from portbench import bench\n"
            "print(bench.forbidden_modules(sys.modules))"
            % (tiny.ROOT, os.path.join(tiny.ROOT, "src")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
