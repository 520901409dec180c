"""The port's parity harness and its scripts against the JAX package's, on
the CPU.

* ``pipeline/parity.run_parity`` with tests/test_parity_pipeline.py's stub
  runtime (it writes deterministic mp4s under the reference's naming):
  the same workloads, configs, seed 76739, pair names, ``generated``,
  ``matched`` and scores as JAX's ``run_parity`` on the same stub outputs
  (scores within 1e-12); the default runtime gets ``device="cuda"``;
* ``scripts/torch_parity_pipeline.py`` and
  ``scripts/torch_compare_outputs.py``: their JSON lines equal the JAX
  scripts' on the same inputs;
* ``scripts/torch_approx_quality.py`` and ``scripts/torch_bench_approx.py``
  on the CPU at the micro UNet's width (4 frames, 8x8 latents, a 6-step
  schedule), their one build driven through ``main``: one JSON line per
  point, the exact point's deviation 0."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from motionclone_tpu.pipeline import parity as jparity
from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.io.video import read_video_frames, write_video
from motionclone_tpu_torch.models.vae import tiny_vae_config
from motionclone_tpu_torch.pipeline import parity as tparity
from test_parity_pipeline import StubRuntime
from test_torch_models import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Stub(StubRuntime):
    """tests/test_parity_pipeline.py's stub runtime, for either package's
    configs."""

    def __init__(self, pretrained_model_path, cfg, **kwargs):
        self.cfg = cfg
        StubRuntime.calls.append((pretrained_model_path, cfg, kwargs))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _noised_references(summary, out_dir, ref_dir, seed):
    r = np.random.default_rng(seed)
    for p in summary["pairs"]:
        frames, _ = read_video_frames(os.path.join(out_dir, p["name"]))
        noised = np.clip(frames.astype(np.int16) + r.integers(-2, 3, frames.shape), 0, 255)
        write_video(os.path.join(ref_dir, p["name"]), noised.astype(np.uint8), fps=8)


def _same_summary(got, want):
    assert [p["name"] for p in got["pairs"]] == [p["name"] for p in want["pairs"]]
    for key in ("generated", "matched"):
        assert got[key] == want[key], key
    for g, w in zip(got["pairs"] + [got], want["pairs"] + [want]):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if isinstance(v, float) and not np.isinf(v):
                assert abs(g[k] - v) <= 1e-12, (k, g[k], v)
            elif k != "pairs":
                assert g[k] == v, k


def test_run_parity_equals_jax_on_the_stub_outputs(tmp_path):
    ref_dir = str(tmp_path / "generated_videos")
    os.makedirs(ref_dir)
    kw = dict(config_root=REPO, runtime_factory=Stub, verbose=False)
    StubRuntime.calls = []
    first = tparity.run_parity(ref_dir, str(tmp_path / "port"), **kw)
    assert first["generated"] == 2 and first["matched"] == 0 and first["psnr_mean"] is None
    assert sorted(p["name"] for p in first["pairs"]) == [
        "camera_zoom_out_Dog,_lying_on_the_grass76739_76739.mp4",
        "sample_white_tiger_Lion,_walks_in_the_forest76739_76739.mp4",
    ]
    # the rgb workload with the rgb config, the sketch one with the sketch config
    assert sorted(c[1].inference_steps for c in StubRuntime.calls) == [100, 200]
    assert all(isinstance(c[1], tcfg.InferenceConfig) for c in StubRuntime.calls)
    assert all(c[2]["device"] == "cuda" for c in StubRuntime.calls)
    _noised_references(first, str(tmp_path / "port"), ref_dir, seed=0)

    got = tparity.run_parity(ref_dir, str(tmp_path / "port"), **kw)
    want = jparity.run_parity(ref_dir, str(tmp_path / "jax"), **kw)
    _same_summary(got, want)
    assert got["matched"] == 2 and got["psnr_mean"] > 30.0 and 0.9 < got["ssim_mean"] <= 1.0
    json.dumps(got)
    assert tparity.REFERENCE_SEED == jparity.REFERENCE_SEED == 76739
    assert tparity.WORKLOADS == jparity.WORKLOADS


def test_parity_script_equals_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tparity, "_default_runtime_factory", Stub)
    monkeypatch.setattr(jparity, "_default_runtime_factory", Stub)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    lines, codes = {}, {}
    for name, script in (("port", "torch_parity_pipeline"), ("jax", "parity_pipeline")):
        StubRuntime.calls = []
        codes[name] = _script(script).main(
            ["--reference-outputs", str(ref_dir), "--output-dir", str(tmp_path / name),
             "--config-root", REPO, "--workloads", "rgb"]
            + (["--device", "cpu"] if name == "port" else []))
        lines[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        if name == "port":
            assert [c[2]["device"] for c in StubRuntime.calls] == ["cpu"]
    assert codes == {"port": 1, "jax": 1}  # nothing matched in an empty directory
    assert lines["port"] == lines["jax"] and lines["port"]["generated"] == 1


def test_compare_script_equals_jax(tmp_path, capsys):
    for d, seed in (("a", 1), ("b", 2)):
        os.makedirs(tmp_path / d)
        for name in ("one.mp4", "two.mp4"):
            frames = np.random.default_rng(seed).integers(0, 256, (3, 16, 16, 3), np.uint8)
            write_video(str(tmp_path / d / name), frames, fps=8)
    (tmp_path / "a" / "notes.txt").write_text("not a video")
    port, jax_script = _script("torch_compare_outputs"), _script("compare_outputs")
    for argv, n in (([str(tmp_path / "a"), str(tmp_path / "b")], 2),
                    ([str(tmp_path / "a" / "one.mp4"), str(tmp_path / "b" / "one.mp4")], 1)):
        out = {}
        for name, mod in (("port", port), ("jax", jax_script)):
            assert mod.main(argv) == 0
            out[name] = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert out["port"] == out["jax"] and len(out["port"]) == n
        assert out["port"][0]["pair"] == "one.mp4 vs one.mp4"
    assert port.main([]) == 2
    os.makedirs(tmp_path / "c")
    assert port.main([str(tmp_path / "a"), str(tmp_path / "c")]) == 1


@pytest.fixture
def tiny_scripts(monkeypatch):
    """The approx scripts at the micro UNet's width on the CPU: 4 frames of
    8x8 latents, a 6-step schedule (3 guided) in chunks of 3."""
    aq = _script("torch_approx_quality")
    monkeypatch.setattr(aq, "model_configs", lambda: (tcfg.micro_unet_config(),
                                                      tiny_vae_config()))
    monkeypatch.setattr(aq, "SIDE", 64)
    monkeypatch.setattr(aq, "FRAMES", 4)
    monkeypatch.setitem(aq.COMMON, "warm_up_steps", 1)
    monkeypatch.setitem(aq.COMMON, "cool_up_steps", 1)
    monkeypatch.setitem(aq.SCHEDULES, "t2v_camera", dict(
        inference_steps=6, guidance_steps=3, guidance_fraction=0.3, chunk_steps=3))
    return aq


@pytest.mark.usefixtures("one_torch_thread")
def test_approx_scripts_run_on_the_cpu(tiny_scripts, monkeypatch, capsys):
    aq = tiny_scripts
    assert aq.main(["--device", "cpu", "--time", "1:1", "2:2:1.0:2:1.0"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["metric"] for x in lines] == [
        "approx_deviation_exact", "approx_deviation_uncond1_guidance1",
        "approx_deviation_uncond2_guidance2_extrap_step2x"]
    assert all(x["card"] == "cpu" and x["sec_per_video"] > 0 for x in lines)
    exact, approx = lines[1], lines[2]
    assert exact["latent_rel_l2"] == 0.0 and exact["decoded_ssim"] == 1.0
    assert approx["latent_rel_l2"] > 0.0

    monkeypatch.setitem(sys.modules, "torch_approx_quality", aq)
    bench = _script("torch_bench_approx")
    assert bench.main(["--device", "cpu", "3:1", "2:2:0.5:2:0.5"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["metric"] for x in lines] == [
        "sec_per_video_t2v_camera_64x64x4f_approx_uncond3_guidance1",
        "sec_per_video_t2v_camera_64x64x4f_approx_uncond2_guidance2_extrap_step2x"]
    assert lines[0]["guided_skip_ms_median"] is None  # no step cache: no skip step
    assert lines[1]["guided_skip_ms_median"] > 0 and lines[1]["vanilla_full_ms_median"] > 0
    assert all(x["value"] > 0 and x["unit"] == "s" for x in lines)
