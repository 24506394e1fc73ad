"""No module of the benchmark imports JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), and the
reference imports nothing of the port."""
import ast
import os

import pytest

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "quadrupedwholebodycontroller_tpu"}
PORT = "quadrupedwholebodycontroller_tpu_torch"


def _modules():
    for d, _, files in os.walk(run.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith(PORT):
            yield node.value       # a module named to importlib


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, run.HERE))
def test_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN


def test_reference_is_independent_of_the_port():
    ref_dir = os.path.join(run.HERE, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            tops = {n.split(".")[0] for n in _imports(os.path.join(ref_dir, f))}
            assert PORT not in tops, f
            assert tops <= {"__future__", "dataclasses", "typing", "torch", "numpy", "math",
                            "json", "os", "functools", "benchmark"}, (f, tops)


def test_a_run_refuses_without_a_card(tmp_path):
    """Without CUDA the command exits non-zero and prints no result."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
                        "step.walk", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
