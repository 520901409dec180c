"""Hygiene of the PyTorch port: its imports (no JAX; none of the packages
the card's machine lacks: yaml, regex, safetensors, PIL, transformers; cv2
only inside io/video.py's codec functions, the image decoder among them),
its device default, and the chip smoke script's refusal to run without
CUDA.

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
# packages of the JAX runtime that the card's machine does not have
NOT_ON_THE_CARD = {"yaml", "regex", "safetensors", "PIL", "transformers"}
CODEC_FUNCTIONS = ("read_video_frames", "write_video", "read_image_rgb")  # of io/video.py
PORT_FILES = sorted(PORT.rglob("*.py"))


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


# the rank bodies of the frame-sharding and layout tests start in processes of their
# own, which must not pay for importing JAX; the port's scripts run on the
# card's machine, which has no JAX
@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py",
                                               ROOT / "tests" / "test_torch_frame_shard_ranks.py",
                                               ROOT / "tests" / "test_torch_layouts_ranks.py"]
                         + sorted((ROOT / "scripts").glob("torch_*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & FORBIDDEN, f"{path} imports {sorted(roots & FORBIDDEN)}"


def test_scan_covers_every_subpackage():
    found = {p.relative_to(PORT).parts[0] for p in PORT_FILES if p.parent != PORT}
    assert found == {"diffusion", "io", "models", "ops", "parallel", "pipeline", "utils",
                     "weights"}
    for rel in ("parallel/frames.py", "cli.py", "i2v.py", "io/video.py", "pipeline/runner.py",
                "models/sparse_controlnet.py"):
        assert PORT / rel in PORT_FILES


def test_scan_sees_forbidden_imports():
    tree = ast.parse("import jax.numpy as jnp\nfrom motionclone_tpu.ops import x\n"
                     "from motionclone_tpu_torch import y\n")
    assert set(_imported_roots(tree)) == {"jax", "motionclone_tpu",
                                          "motionclone_tpu_torch"}


def _import_faults(tree: ast.AST, is_video_module: bool) -> list:
    """Imports of packages the card's machine lacks, and imports of cv2
    anywhere but inside io/video.py's codec functions."""
    faults = []

    def visit(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        roots = []
        if isinstance(node, ast.Import):
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots = [node.module.split(".")[0]]
        for root in roots:
            if root in NOT_ON_THE_CARD:
                faults.append(f"line {node.lineno} imports {root}")
            if root == "cv2" and not (is_video_module and func in CODEC_FUNCTIONS):
                faults.append(f"line {node.lineno} imports cv2 outside the codec functions")
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(tree, None)
    return faults


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_imports_the_card_lacks(path):
    tree = ast.parse(path.read_text(), str(path))
    assert _import_faults(tree, path == PORT / "io" / "video.py") == []


def test_import_scan_sees_planted_imports():
    planted = ("import yaml\nfrom safetensors.numpy import load_file\nimport cv2\n"
               "def read_video_frames(p):\n    import cv2, regex\n"
               "def other():\n    from PIL import Image\n    import cv2\n"
               "class C:\n    import transformers\n")
    assert _import_faults(ast.parse(planted), is_video_module=True) == [
        "line 1 imports yaml", "line 2 imports safetensors",
        "line 3 imports cv2 outside the codec functions", "line 5 imports regex",
        "line 7 imports PIL", "line 8 imports cv2 outside the codec functions",
        "line 10 imports transformers"]
    assert _import_faults(ast.parse("def write_video():\n    import cv2\n"), False) == [
        "line 2 imports cv2 outside the codec functions"]
    assert _import_faults(ast.parse("def write_video():\n    import cv2\n"), True) == []


def test_cli_defaults_to_cuda():
    from motionclone_tpu_torch.cli import build_parser

    args = build_parser("a.yaml", "b.jsonl").parse_args([])
    assert args.device == "cuda"
    assert build_parser("a.yaml", "b.jsonl").parse_args(["--device", "cpu"]).device == "cpu"


def test_runtime_refuses_cuda_it_lacks_and_runs_on_cpu_when_asked(tmp_path):
    """Without CUDA the runtime raises before it reads a file; with
    device="cpu" it goes on to the files (here: none)."""
    from motionclone_tpu_torch.pipeline.runner import MotionCloneRuntime

    infer = tcfg.InferenceConfig(model_config="model_config.yaml")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MotionCloneRuntime(str(tmp_path / "absent"), infer, config_root=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="model_config.yaml"):
        MotionCloneRuntime(str(tmp_path / "absent"), infer, device="cpu",
                           config_root=str(tmp_path))


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
