"""What the benchmark loads: no module whose top-level name (the part
before the first dot, compared whole) is ``jax``, ``flax`` or the JAX
package ``motionclone_tpu``, in its sources or in a process that runs a
job; and nothing of the program under ``reference/``."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "motionclone_tpu"}


def imported_top_levels(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_the_reference_imports_nothing_of_the_program(path):
    assert not imported_top_levels(path) & {"motionclone_tpu_torch", "motionclone_tpu"}
    assert imported_top_levels(path) <= {"__future__", "math", "typing", "numpy", "torch",
                                         "bench_h100"}


def test_a_run_loads_no_jax_module():
    """A tiny job through the harness and the program in a fresh process,
    then every loaded module's top-level name."""
    code = (
        "import sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from bench_h100 import harness, run\n"
        "from bench_h100.tests.tiny import tiny_cell\n"
        "harness.run(tiny_cell('i2v_rgb.b1'), 5, 0.0, True, 'cpu', time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, found = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "'motionclone_tpu_torch'" in loaded and "'jax'" not in loaded
