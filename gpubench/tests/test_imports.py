"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the program's name begins with the JAX package's),
and the plain reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from gpubench import spec

BENCH = os.path.join(spec.ROOT, "gpubench")
FORBIDDEN = {"jax", "jaxlib", "flax", "ballista_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        found = set(_imports(path)) & FORBIDDEN
        assert not found, (path, found)
    # the program's name is not taken for the JAX package's
    assert "ballista_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "reference")):
        assert "ballista_tpu_torch" not in set(_imports(path)), path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gpubench.reference.tpch, gpubench.reference.h2o\n"
            "import gpubench.answer, gpubench.control\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ballista_tpu_torch', 'ballista_tpu', 'jax'})\n"
            "assert not bad, bad" % spec.ROOT)
    subprocess.run([sys.executable, "-c", code], check=True)
