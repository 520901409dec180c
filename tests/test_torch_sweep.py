"""The port's sweep against the JAX package's, on the CPU in f32.

One synthetic model directory (tests/test_torch_runtime.py's ``model_dir``)
serves every case; the JAX sweep runs once, in a module-scoped fixture, on
a JAX ``MotionCloneRuntime`` of the same directory
(``attention_impl="xla"``), and the port takes JAX's noise through the
``utils.rng.draw_normal`` seam (tests/test_torch_sweep_i2v.py holds the
i2v sweep the same way):

* ``pad_to_multiple``, ``batch_examples`` and ``partition_examples`` equal
  the JAX functions (1-7 examples, batches of 1-3, 1-3 processes,
  out-of-range ids raising);
* ``run_sweep`` on 3 examples at ``num_devices=2`` (a full batch and a
  padded one): the final latents agree with JAX's within the sampling
  parity tolerance of tests/test_torch_pipeline.py (atol = rtol = 2e-3),
  the mp4 names are equal, the representation ``.npz`` files carry equal
  meta, and each batch's resume file has JAX's name;
* each batched example's latents equal its own ``run_example`` run within
  atol = rtol = 1e-4 (f32 on the CPU: the batch's products and
  convolutions take other blockings than batch 1's);
* a second sweep hits the representation cache (no VAE encode) and makes
  one CLIP call per batch; an interrupted ``--resume`` sweep continues to
  the uninterrupted latents, bit for bit;
* ``sweep_main --num-processes 2 --process-id r`` for r = 0, 1 writes the
  single process's set between them; ``--approx`` reaches the sweep; torchrun's environment puts a rank on
  ``cuda:LOCAL_RANK``; ``--frame-shard``, ``--frame-shard-mode gspmd`` and
  ``--cfg-pair`` exit naming ROADMAP.md;
* the kernels' bindings refuse a tensor of 2**31 elements or more (a
  batch too large for their 32-bit counts) before a launch."""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu.config import Example as JExample
from motionclone_tpu.config import load_inference_config as j_load_inference_config
from motionclone_tpu.diffusion.guidance import load_motion_representation_meta as j_meta
from motionclone_tpu.parallel import distributed as jdist
from motionclone_tpu.pipeline import sweep as jsweep
from motionclone_tpu.pipeline.runner import MotionCloneRuntime as JRuntime
from motionclone_tpu_torch.cli import UNPORTED, sweep_main
from motionclone_tpu_torch.config import Example, load_inference_config
from motionclone_tpu_torch.diffusion.guidance import load_motion_representation_meta
from motionclone_tpu_torch.io.video import write_video
from motionclone_tpu_torch.models.vae import AutoencoderKL
from motionclone_tpu_torch.parallel import distributed as tdist
from motionclone_tpu_torch.pipeline import runner
from motionclone_tpu_torch.pipeline import sweep as tsweep
from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline
from motionclone_tpu_torch.utils import rng as trng
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_runtime import SD, _jax_draw, model_dir  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (video, prompt, seed): 3 examples, so num_devices=2 gives a full batch
# and a padded one
T2V = (("va.mp4", "a cat running", 42), ("vb.mp4", "a dog", 7), ("vc.mp4", "a car", 3))
SAMPLING_TOL = dict(atol=2e-3, rtol=2e-3)  # tests/test_torch_pipeline.py's
SERIAL_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg(root, name):
    return load_inference_config(os.path.join(root, name), width=64, height=64,
                                 video_length=4)


@pytest.fixture(scope="module")
def sweep_dir(model_dir):  # noqa: F811
    r = np.random.default_rng(11)
    for name, _, _ in T2V:
        write_video(os.path.join(model_dir, name),
                    r.integers(0, 255, size=(6, 64, 64, 3), dtype=np.uint8), fps=8)
    with open(os.path.join(model_dir, "sweep.jsonl"), "w") as f:
        for video, prompt, seed in T2V:
            f.write(json.dumps({"video_path": video, "new_prompt": prompt, "seed": seed})
                    + "\n")
    return model_dir


def _jax_sweep(root, cfg_name, examples, out):
    """JAX's run_sweep at num_devices=2 with resume on: the mp4 paths, each
    decoded example's latents and each batch's resume path."""
    cfg = j_load_inference_config(os.path.join(root, cfg_name), width=64, height=64,
                                  video_length=4)
    rt = JRuntime(os.path.join(root, SD), cfg, dtype=jnp.float32, attention_impl="xla",
                  config_root=root)
    latents, resume = [], []
    decode, sample = rt.decode_latents, rt.pipeline.fns.sample
    rt.decode_latents = lambda z: (latents.append(np.asarray(z)), decode(z))[1]

    def spy(*args, **kwargs):
        resume.append(os.path.basename(kwargs["resume_path"]))
        return sample(*args, **kwargs)

    rt.pipeline.fns = dataclasses.replace(rt.pipeline.fns, sample=spy)
    paths = jsweep.run_sweep(rt, examples, motion_rep_dir=os.path.join(root, out, "reps"),
                             output_dir=os.path.join(root, out, "out"), config_root=root,
                             num_devices=2, resume=True)
    return dict(paths=[os.path.relpath(p, root) for p in paths], latents=latents,
                resume=resume)


def _port_sweep(rt, root, examples, out, **kwargs):
    """The port's run_sweep at num_devices=2: the mp4 paths, each written
    example's latents and each batch's resume path."""
    latents, resume = [], []
    write, sample = rt.write_latents, MotionClonePipeline.sample_latents

    def spy(self, *args, **kw):
        resume.append(kw["resume_path"] and os.path.basename(kw["resume_path"]))
        return sample(self, *args, **kw)

    rt.write_latents = lambda path, z: (latents.append(z.clone()), write(path, z))[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MotionClonePipeline, "sample_latents", spy)
        try:
            paths = tsweep.run_sweep(rt, examples, motion_rep_dir=os.path.join(root, out, "reps"),
                                     output_dir=os.path.join(root, out, "out"),
                                     config_root=root, num_devices=2, verbose=False, **kwargs)
        finally:
            del rt.write_latents
    return dict(paths=[os.path.relpath(p, root) for p in paths], latents=latents,
                resume=resume)


def _serial(rt, root, examples, out):
    """Each example alone through run_example: its final latents."""
    latents = []
    sample = MotionClonePipeline.sample_latents

    def spy(self, *args, **kwargs):
        latents.append(sample(self, *args, **kwargs))
        return latents[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MotionClonePipeline, "sample_latents", spy)
        for e in examples:
            rt.run_example(e, motion_rep_dir=os.path.join(root, out, "reps"),
                           output_dir=os.path.join(root, out, "out"), config_root=root,
                           verbose=False)
    return latents


@pytest.fixture(scope="module")
def t2v(sweep_dir):
    """One JAX sweep, the port's sweep and serial runs, all on JAX's noise."""
    root = sweep_dir
    jax_run = _jax_sweep(root, "inference.yaml", [JExample(v, p, s) for v, p, s in T2V],
                         "jax")
    examples = [Example(v, p, s) for v, p, s in T2V]
    rt = runner.MotionCloneRuntime(os.path.join(root, SD), _cfg(root, "inference.yaml"),
                                   device="cpu", dtype=torch.float32, config_root=root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trng, "draw_normal", _jax_draw)
        port = _port_sweep(rt, root, examples, "port", resume=True)
        serial = _serial(rt, root, examples, "serial")
    return dict(root=root, rt=rt, examples=examples, jax=jax_run, port=port, serial=serial)


# ---------------------------------------------------------------------------
# batching and partitioning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("n", range(1, 8))
def test_batching_equals_jax(n, batch):
    items = [f"example {i}" for i in range(n)]
    assert tsweep.pad_to_multiple(n, batch) == jsweep.pad_to_multiple(n, batch)
    assert tsweep.batch_examples(items, batch) == jsweep.batch_examples(items, batch)


def test_negative_batch_size_raises(tmp_path):
    with pytest.raises(ValueError, match="num_devices"):
        tsweep.run_sweep(SimpleNamespace(), [Example("v.mp4", "p")], num_devices=-1,
                         motion_rep_dir=str(tmp_path / "r"), output_dir=str(tmp_path / "o"))


@pytest.mark.parametrize("count", [1, 2, 3])
@pytest.mark.parametrize("n", range(1, 8))
def test_partition_equals_jax(n, count):
    items = list(range(n))
    shares = [tdist.partition_examples(items, pid, count) for pid in range(count)]
    assert shares == [jdist.partition_examples(items, pid, count) for pid in range(count)]
    assert sorted(sum(shares, [])) == items
    for pid in (-1, count):
        with pytest.raises(ValueError, match="out of range"):
            tdist.partition_examples(items, pid, count)
        with pytest.raises(ValueError, match="out of range"):
            jdist.partition_examples(items, pid, count)


# ---------------------------------------------------------------------------
# t2v
# ---------------------------------------------------------------------------


def test_sweep_latents_equal_jax(t2v):
    got, want = t2v["port"]["latents"], t2v["jax"]["latents"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 4, 8, 8, 4)
        np.testing.assert_allclose(g.numpy(), w, **SAMPLING_TOL)


def test_sweep_names_and_rep_meta_equal_jax(t2v):
    root = t2v["root"]
    names = [os.path.basename(p) for p in t2v["port"]["paths"]]
    assert names == [os.path.basename(p) for p in t2v["jax"]["paths"]]
    assert names[0] == "va_a_cat_running8k,_high_detail42_42.mp4"
    assert all(os.path.getsize(os.path.join(root, p)) > 0 for p in t2v["port"]["paths"])
    for video, _, seed in T2V:
        stem = os.path.splitext(video)[0] + ".npz"
        meta = load_motion_representation_meta(os.path.join(root, "port", "reps", stem))
        assert meta == j_meta(os.path.join(root, "jax", "reps", stem))
        assert meta == runner.motion_rep_meta(t2v["rt"].infer_cfg, seed)


def test_resume_file_names_equal_jax(t2v):
    names = t2v["port"]["resume"]
    assert names == t2v["jax"]["resume"] and len(set(names)) == 2
    assert all(n.startswith(".resume_sweep_") for n in names)
    assert not [f for f in os.listdir(os.path.join(t2v["root"], "port", "out"))
                if f.startswith(".resume")]


def test_batched_examples_equal_their_serial_runs(t2v):
    for got, want in zip(t2v["port"]["latents"], t2v["serial"]):
        torch.testing.assert_close(got, want, **SERIAL_TOL)


def test_second_sweep_hits_the_rep_cache_with_one_clip_call_per_batch(t2v, monkeypatch):
    calls = {"clip": 0, "vae": 0}
    encode_text, encode = MotionClonePipeline.encode_text, AutoencoderKL.encode

    def clip_spy(self, ids):
        calls["clip"] += 1
        assert ids.shape == (2 * 2 + 1, 77)  # 2B + 1 rows
        return encode_text(self, ids)

    def vae_spy(self, *args, **kwargs):
        calls["vae"] += 1
        return encode(self, *args, **kwargs)

    monkeypatch.setattr(MotionClonePipeline, "encode_text", clip_spy)
    monkeypatch.setattr(AutoencoderKL, "encode", vae_spy)
    monkeypatch.setattr(trng, "draw_normal", _jax_draw)
    again = _port_sweep(t2v["rt"], t2v["root"], t2v["examples"], "port")
    assert calls == {"clip": 2, "vae": 0}
    assert "extract" not in t2v["rt"].timings
    assert sorted(t2v["rt"].timings) == ["decode_write", "guided_ms", "guided_skip_ms",
                                         "passes_ms", "sample", "text", "vanilla_ms",
                                         "vanilla_skip_ms", "weights_cache"]
    for got, want in zip(again["latents"], t2v["port"]["latents"]):
        assert torch.equal(got, want)


class _Interrupted(Exception):
    pass


def test_interrupted_sweep_resumes(t2v, monkeypatch):
    rt, root = t2v["rt"], t2v["root"]
    sample = MotionClonePipeline.sample_latents
    g = rt.infer_cfg.guidance_steps

    def stop(done, total):
        if done == g:
            raise _Interrupted

    monkeypatch.setattr(trng, "draw_normal", _jax_draw)
    with monkeypatch.context() as mp:
        mp.setattr(MotionClonePipeline, "sample_latents",
                   lambda self, *a, **kw: sample(self, *a, on_chunk=stop, **kw))
        with pytest.raises(_Interrupted):
            _port_sweep(rt, root, t2v["examples"], "resumed", resume=True)
    out = os.path.join(root, "resumed", "out")
    assert [f for f in os.listdir(out) if f.startswith(".resume")] == \
        [t2v["port"]["resume"][0]]
    guided, timed = [], rt.sample_timed

    def timed_spy(*args, **kwargs):  # guided steps run per batch
        out = timed(*args, **kwargs)
        guided.append(len(args[6]["guided_ms"]))
        return out

    monkeypatch.setattr(rt, "sample_timed", timed_spy)
    again = _port_sweep(rt, root, t2v["examples"], "resumed", resume=True)
    assert guided == [0, g]  # the first batch continued at its vanilla chunk
    for got, want in zip(again["latents"], t2v["port"]["latents"]):
        assert torch.equal(got, want)
    assert not [f for f in os.listdir(out) if f.startswith(".resume")]


# ---------------------------------------------------------------------------
# the CLI and the process split
# ---------------------------------------------------------------------------


def _sweep_argv(root):
    return ["--pretrained-model-path", SD, "--inference_config", "inference.yaml",
            "--examples", "sweep.jsonl", "--motion-representation-save-dir", "cli_reps",
            "--W", "64", "--H", "64", "--L", "4", "--float32", "--device", "cpu",
            "--num-devices", "2"]


def test_sweep_main_splits_the_examples_over_processes(sweep_dir, monkeypatch):
    monkeypatch.chdir(sweep_dir)
    _, single = sweep_main(_sweep_argv(sweep_dir) + ["--generated-videos-save-dir", "cli_1"])
    union = []
    for r in (0, 1):
        rt, paths = sweep_main(_sweep_argv(sweep_dir) + [
            "--generated-videos-save-dir", "cli_2", "--num-processes", "2",
            "--process-id", str(r)])
        assert rt.device.type == "cpu" and len(paths) == (2, 1)[r]
        union += paths
    assert sorted(os.path.basename(p) for p in union) == \
        sorted(os.path.basename(p) for p in single)
    assert len(single) == 3
    assert sorted(f for f in os.listdir("cli_2") if f.endswith(".mp4")) == \
        sorted(os.path.basename(p) for p in single)


def test_sweep_main_carries_approx(sweep_dir, monkeypatch):
    """``--approx`` reaches every sweep: the batch's steps follow the step
    cache's flags (skip steps run DDIM only)."""
    monkeypatch.chdir(sweep_dir)
    rt, paths = sweep_main(_sweep_argv(sweep_dir) + [
        "--generated-videos-save-dir", "cli_approx", "--examples", "examples.jsonl",
        "--approx", "step-extrap:2"])
    full = rt.pipeline.fns.schedule().full
    assert len(paths) == 1 and not full.all()
    assert len(rt.timings["guided_skip_ms"]) + len(rt.timings["vanilla_skip_ms"]) == \
        int((~full).sum()) > 0


# the JAX package's layout flags and the refusal that applies to each
# outside torchrun: the GSPMD flavour is not ported (its ROADMAP.md list);
# --frame-shard and --cfg-pair (the sweep's (data, cfg) layout) need a
# torchrun world of their ranks per video
_UNPORTED_ARGV = {"frame_shard": (["--frame-shard", "2"], "torchrun --nproc-per-node 2"),
                  "frame_shard_mode": (["--frame-shard-mode", "gspmd"], "ROADMAP.md"),
                  "cfg_pair": (["--cfg-pair"], "torchrun --nproc-per-node 2")}


@pytest.mark.parametrize("flag", sorted(_UNPORTED_ARGV))
def test_sweep_main_refuses_unported_flags(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # exits before it reads a file
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv, message = _UNPORTED_ARGV[flag]
    assert (flag in UNPORTED) == (message == "ROADMAP.md")
    with pytest.raises(SystemExit, match=message):
        sweep_main(_sweep_argv(str(tmp_path)) + argv)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("device, want", [("cuda", "cuda:3"), ("cpu", "cpu"),
                                          ("cuda:1", "cuda:1")])
def test_torchrun_environment_sets_the_rank_and_its_card(device, want, monkeypatch):
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "3")
    args = SimpleNamespace(device=device, coordinator="", num_processes=0, process_id=-1,
                           distributed=True)
    assert tdist.maybe_initialize_from_args(args) is True
    assert (args.device, args.process_id, args.num_processes) == (want, 5, 8)
    assert tdist.partition_examples(list(range(20))) == [5, 13]


def test_distributed_flags_are_checked(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    args = lambda **kw: SimpleNamespace(**dict(dict(
        device="cpu", coordinator="", num_processes=0, process_id=-1, distributed=False), **kw))
    assert tdist.maybe_initialize_from_args(args()) is False
    with pytest.raises(ValueError, match="torchrun"):
        tdist.maybe_initialize_from_args(args(distributed=True))
    with pytest.raises(ValueError, match="--process-id"):
        tdist.maybe_initialize_from_args(args(num_processes=2))
    with pytest.raises(ValueError, match="out of range"):
        tdist.maybe_initialize_from_args(args(num_processes=2, process_id=2))
    assert tdist.maybe_initialize_from_args(args(coordinator="h:1", num_processes=1,
                                                 process_id=0)) is False


def test_kernels_refuse_tensors_past_32_bit_counts():
    """A batch of many examples at full size would hand the kernels a
    tensor of 2**31 elements or more, which their 32-bit counts cannot
    hold: the bindings refuse it before a launch (meta tensors: no
    memory), and the largest tensor of a batch of 2 at 512x512x16 passes."""
    from motionclone_tpu_torch.ops import build

    build.check_extent(torch.empty(64, 64, 64, 640, device="meta"), None)
    with pytest.raises(ValueError, match="--num-devices"):
        build.check_extent(torch.empty(2**31, device="meta"))
    with pytest.raises(ValueError, match="--num-devices"):
        build.pointers(torch.empty(832, 64, 64, 640, device="meta"))
    with pytest.raises(ValueError, match="32-bit"):
        build.ints(4, 2**31)
    assert list(build.ints(1, -1, 2**31 - 1)) == [1, -1, 2**31 - 1]
