"""Nothing the benchmark runs imports JAX or the JAX package (by whole
top-level name: the port's name begins with the JAX package's), and the
plain reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from portbench import core

FORBIDDEN = {"jax", "jaxlib", "flax", "nefii_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(core.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "nefii_tpu_torch" not in set(_imports(path)), path


def test_a_cpu_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from tiny import tiny_run\nfrom portbench import run as R\n"
            "R.run_cell(tiny_run('nefii.render256', seconds=0.1))\n"
            "from portbench import core\nprint(core.loaded_forbidden())\n"
            % (core.ROOT, os.path.dirname(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([core.HERE, core.ROOT]))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env, cwd=core.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_fails_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    p = subprocess.run([sys.executable, os.path.join(core.HERE, "run.py"), "--workload",
                        "nefii.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=core.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
