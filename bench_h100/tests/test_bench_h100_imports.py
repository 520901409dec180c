"""What the benchmark loads: no module whose top-level name (the part
before the first dot, compared whole) is ``jax``, ``flax`` or the JAX
package ``motionclone_tpu``, in its sources or in a process that runs a
job; nothing of the program under ``reference/``; and no network in the
harness core, which reaches a model only through its family module."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "motionclone_tpu"}
READERS = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
                 if f.endswith(".py") and f != "__init__.py")
CORE = ["run.py", "harness.py", "check.py", "trace.py"] + [f"metrics/{r}.py" for r in READERS]
NETWORKS = ("motionclone_tpu_torch.models", "bench_h100.reference.nets")


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


def imported_names(path):
    """Every module an import names, and ``module.name`` of each name a
    ``from`` import takes (a submodule, or a name of the module)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names |= {node.module} | {f"{node.module}.{a.name}" for a in node.names}
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


@pytest.mark.parametrize("path", CORE)
def test_the_harness_core_imports_no_network(path):
    names = imported_names(os.path.join(HERE, path))
    assert not {n for n in names for net in NETWORKS if n == net or n.startswith(net + ".")}


def test_importing_the_core_loads_no_network():
    code = ("import sys\n"
            "import bench_h100.run, bench_h100.harness, bench_h100.check, bench_h100.trace\n"
            f"for r in {READERS!r}:\n"
            "    bench_h100.harness.load_reader(r)\n"
            f"print(sorted(m for m in sys.modules if m.startswith({NETWORKS!r})))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


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
