"""Hygiene of the PyTorch port: its imports, its device default, and the
chip smoke script's refusal to run without CUDA.

The import check reads the sources with ``ast``: the interpreter may have
imported jax before any test runs, so ``sys.modules`` proves nothing."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline, resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "motionclone_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "motionclone_tpu"}
PORT_FILES = sorted(PORT.rglob("*.py"))


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


# the rank bodies of the frame-sharding tests start in processes of their
# own, which must not pay for importing JAX; the port's scripts run on the
# card's machine, which has no JAX
@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py",
                                               ROOT / "tests" / "test_torch_frame_shard_ranks.py"]
                         + sorted((ROOT / "scripts").glob("torch_*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & FORBIDDEN, f"{path} imports {sorted(roots & FORBIDDEN)}"


def test_scan_covers_every_subpackage():
    found = {p.relative_to(PORT).parts[0] for p in PORT_FILES if p.parent != PORT}
    assert found == {"diffusion", "models", "ops", "parallel", "pipeline", "weights"}
    assert PORT / "parallel" / "frames.py" in PORT_FILES


def test_scan_sees_forbidden_imports():
    tree = ast.parse("import jax.numpy as jnp\nfrom motionclone_tpu.ops import x\n"
                     "from motionclone_tpu_torch import y\n")
    assert set(_imported_roots(tree)) == {"jax", "motionclone_tpu",
                                          "motionclone_tpu_torch"}


def _pipeline(**kw):
    infer = tcfg.InferenceConfig(inference_steps=2, guidance_steps=1,
                                 width=64, height=64, video_length=2)
    cfg = tcfg.micro_unet_config()
    return MotionClonePipeline(cfg, tcfg.NoiseScheduleConfig(), infer,
                               UNet3DConditionModel(cfg), **kw)


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _pipeline()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_entry_point_runs_on_cpu_when_asked():
    pipe = _pipeline(device="cpu", dtype=torch.float32)
    assert pipe.device.type == "cpu"
    assert pipe.unet.conv_in.weight.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
