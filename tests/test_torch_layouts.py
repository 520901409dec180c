"""The port's multi-device layouts vs the JAX package, on the CPU in f32.

The layouts are ``parallel.frames.Layout``s of 4 gloo ranks (one launch,
``parallel.frames.launch``; the rank bodies live in
test_torch_layouts_ranks.py, which imports no JAX), against the JAX
package's meshes on the 8 virtual CPU devices of conftest.py:

* (a) (cfg 2, frames 2): the micro UNet's extraction, ``sample`` (2 guided
  + 1 vanilla steps) and first guided step's loss against
  ``make_sampling_fns(frame_shard_map=make_mesh_video(frames=2, cfg=2))``,
  as tests/test_parallel.py holds JAX's own;
* (b) (cfg 2, frames 1), the CFG pair alone: against
  ``cfg_pair_sharding(make_mesh_2d(data=1, cfg=2))`` (JAX's
  ``guided_step_pair``); its second data group samples a batch of 2, whose
  first example must equal the first group's;
* (c) the frame-sharded controlnet over 2 ranks, the i2v latent (RGB) and
  pixel (sketch) flavours, one per data group, against JAX's controlnet
  built with ``frames_axis="frames"`` under ``make_mesh_video(frames=2)``,
  on tests/test_torch_sparse_controlnet.py's tiny UNet, controlnets,
  inputs and schedule (4 steps, 2 guided; its unsharded port-vs-JAX case
  holds there at the tolerance below); ``sample`` without a condition is
  refused;
* (d) (data 2, frames 2): each data group samples its example alone and
  the batch of both, against JAX's ``make_mesh_sweep(data=2, frames=2)``;
  a batch under a frame group equals its examples run alone.

Tolerances are tests/test_torch_frame_shard.py's: representation values
2e-5 / 1e-4 with indices equal; latents 2e-3 / 2e-3 against JAX and 2e-4 /
1e-3 against the port's unsharded run.

Then the CLIs under 2 gloo ranks on the CPU (one launch): ``t2v_main
--frame-shard 2`` (with a weights cache that rank 0 alone writes),
``i2v_main --frame-shard 2`` (the RGB flavour), ``sweep_main --frame-shard
2`` and ``--cfg-pair`` and ``serve_main --frame-shard 2`` with one job, from a tiny model
directory as tests/test_torch_runtime.py builds it: each writes one mp4
whose latents equal the unsharded CLI run's.  And the refusals: the approx
caches with a CFG pair, a world of the wrong size, nccl on the CPU, the
layout flags outside torchrun."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from motionclone_tpu import config as jcfg
from motionclone_tpu.models import sparse_controlnet as jsc
from motionclone_tpu.models.unet3d import UNet3DConditionModel as JUNet
from motionclone_tpu.parallel.mesh import (
    cfg_pair_sharding,
    make_mesh_2d,
    make_mesh_sweep,
    make_mesh_video,
    shard_params,
)
from motionclone_tpu.pipeline.motionclone import (
    make_controlnet_apply,
    make_sampling_fns as j_make_fns,
)
from motionclone_tpu_torch import cli
from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.io.video import read_video_frames, write_video
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel as TUNet
from motionclone_tpu_torch.parallel.frames import FrameGroup, launch
from motionclone_tpu_torch.pipeline.motionclone import (
    MotionClonePipeline,
    make_sampling_fns as t_make_fns,
)
from motionclone_tpu_torch.weights.from_jax import state_dict_from_flax
from test_cli_synthetic_e2e import _build_controlnet, _build_model_dir
from test_sparse_controlnet import tiny_cn_config
from test_torch_layouts_ranks import clis_rank, layouts_rank
from test_torch_models import load_port, one_torch_thread, random_flax_params  # noqa: F401
from test_torch_sparse_controlnet import _build as build_controlnet, _cond_shape
from test_torch_sparse_controlnet import _infer as cn_infer

RANKS = 4
LAUNCH_TIMEOUT_S = 300.0
GUIDANCE = ("up_blocks.1",)
F_, HW = 8, 16  # the micro UNet's video: 4 frames per rank at 2 shards
CN_F = 4  # the controlnet's (tiny UNet) video: 2 frames per rank
FLAVOURS = ("latent", "pixel")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(x):
    return torch.from_numpy(np.array(x))


def _infer(mod):
    # tests/test_parallel.py's schedule: 3 steps, 2 guided
    return mod.InferenceConfig(
        inference_steps=3, guidance_steps=2, guidance_fraction=0.3,
        warm_up_steps=1, cool_up_steps=1, motion_guidance_weight=50.0,
        motion_guidance_blocks=GUIDANCE, add_noise_step=400, cfg_scale=7.5,
        width=HW * 8, height=HW * 8, video_length=F_,
    )


def _inputs(rng, batch, frames=F_, ctx=16):
    shape = (batch, frames, HW, HW, 4)
    video_latents, noise, init = (rng.standard_normal(shape).astype(np.float32)
                                  for _ in range(3))
    uncond, cond = (rng.standard_normal((batch, 7, ctx)).astype(np.float32) for _ in range(2))
    return dict(video_latents=video_latents, noise=noise, init=init, uncond=uncond, cond=cond)


def _case(params, unet_cfg, inputs, infer=None, **extra):
    """The rank body's keyword arguments: the port's weights, configs and
    the inputs as tensors."""
    return dict(state_dict=state_dict_from_flax(params), unet_cfg=unet_cfg,
                sched_cfg=tcfg.NoiseScheduleConfig(), infer_cfg=infer or _infer(tcfg),
                **{k: _t(v) for k, v in inputs.items()}, **extra)


@pytest.fixture(scope="module")
def layouts():
    """The inputs and weights made with numpy, JAX's and the 4 ranks'
    models, and the ranks' results."""
    rng = np.random.default_rng(12)
    one = _inputs(rng, 1)
    x = jnp.asarray(one["init"])
    micro = JUNet(cfg=jcfg.micro_unet_config(), guidance_blocks=GUIDANCE, attention_impl="xla")
    params = random_flax_params(micro, x, jnp.zeros((1,), jnp.int32), one["uncond"], seed=13)
    pair_one, pair_two = _inputs(rng, 1), _inputs(rng, 2)
    pair_two = {k: np.concatenate([pair_one[k], v[1:]]) for k, v in pair_two.items()}
    sweep = _inputs(rng, 2)
    # (c): tests/test_torch_sparse_controlnet.py's tiny UNet (``unet_pair``),
    # controlnets (``models``) and inputs, the condition at frames 0 and 3
    tiny = JUNet(cfg=jcfg.tiny_unet_config(), guidance_blocks=GUIDANCE, attention_impl="xla")
    x50 = np.random.default_rng(50).standard_normal((1, CN_F, HW, HW, 4)).astype(np.float32)
    tiny_params = random_flax_params(tiny, x50, jnp.zeros((1,), jnp.int32),
                                     np.zeros((1, 7, 16), np.float32), seed=51)
    cns, cn_cases = {}, []
    for i, flavour in enumerate(FLAVOURS):
        jm, cn_params, tm = build_controlnet(tiny_cn_config(simplified=flavour == "latent"),
                                             seed=40 + i)
        r = np.random.default_rng(61)
        cn_in = _inputs(r, 1, CN_F)
        frames = r.standard_normal((1, 2) + _cond_shape(jm.cfg)[2:]).astype(np.float32)
        cond, mask = (np.asarray(a) for a in jsc.scatter_condition(jnp.asarray(frames),
                                                                   (0, 3), CN_F))
        cns[flavour] = (jm, cn_params, tm, cond, mask, cn_in)
        cn_cases.append(_case(tiny_params, tcfg.tiny_unet_config(), cn_in, cn_infer(tcfg),
                              controlnet={"cfg": tm.cfg, "state_dict": tm.state_dict()},
                              cn_cond=(_t(cond), _t(mask), 0.8)))
    cases = {"a": _case(params, tcfg.micro_unet_config(), one),
             "b": [_case(params, tcfg.micro_unet_config(), pair_one),
                   _case(params, tcfg.micro_unet_config(), pair_two)],
             "c": cn_cases, "d": _case(params, tcfg.micro_unet_config(), sweep)}
    results = launch(layouts_rank, RANKS, backend="gloo", args=(cases,),
                     timeout=LAUNCH_TIMEOUT_S, layout=(1, 2, 2))
    return dict(results=results, params=params, one=one, pair_one=pair_one, sweep=sweep,
                tiny_params=tiny_params, cns=cns)


def _assert_rep(got, want, label, atol=2e-5, rtol=1e-4):
    assert sorted(got) == sorted(want), label
    for k, (vals, idx) in got.items():
        np.testing.assert_allclose(np.asarray(vals), np.asarray(want[k][0]), atol=atol,
                                   rtol=rtol, err_msg=f"{label} {k}")
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(want[k][1]),
                                      err_msg=f"{label} {k}")


def _port_unsharded(params, unet_cfg, inputs, infer=None, controlnet=None, cn_cond=None):
    """The port's unsharded extraction, sampling and first guided loss."""
    unet = load_port(TUNet(unet_cfg), params)
    fns = t_make_fns(unet, tcfg.NoiseScheduleConfig(), infer or _infer(tcfg),
                     controlnet=controlnet)
    x = {k: _t(v) for k, v in inputs.items()}
    rep = fns.extract(x["video_latents"], x["noise"], x["uncond"], cn_cond)
    t, tp = (int(v) for v in fns.timesteps[:2])
    return dict(rep=rep, latents=fns.sample(x["init"], x["uncond"], x["cond"], rep,
                                             cn_cond=cn_cond),
                loss=float(fns.guided_step(x["init"], t, tp, 1.0, x["uncond"], x["cond"],
                                           rep, cn_cond)[1]))


def test_ranks_take_their_places_in_the_layouts(layouts):
    """rank = (d * cfg + c) * frames + f, as JAX's meshes order devices."""
    where = [r["where"] for r in layouts["results"]]
    assert [w["pair_frames"] for w in where] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [w["data_index"] for w in where] == [0, 0, 1, 1]
    assert [w["video_lead"] for w in where] == [True, False, True, False]


def test_cfg_pair_with_frames_matches_jax_shard_map(layouts):
    """(a): every rank's gathered representation and latents against JAX's
    (cfg 2, frames 2) shard_map run and the port's unsharded run; the
    first guided step's loss (the cond half's, summed over the frames) on
    every rank equals the unsharded loss."""
    s = layouts
    mesh = make_mesh_video(frames=2, cfg=2)
    fsh = NamedSharding(mesh, P(None, "frames"))
    fns = j_make_fns(jcfg.micro_unet_config(), jcfg.NoiseScheduleConfig(), _infer(jcfg),
                     dtype=jnp.float32, attention_impl="xla", frame_shard_map=mesh)
    p, x = shard_params(s["params"], mesh), s["one"]
    with mesh:
        rep_j = fns.extract(p, jax.device_put(x["video_latents"], fsh),
                            jax.device_put(x["noise"], fsh), x["uncond"], None, None)
        want = fns.sample(p, jax.device_put(x["init"], fsh), x["uncond"], x["cond"], rep_j,
                          None, None)
    ref = _port_unsharded(s["params"], tcfg.micro_unet_config(), x)
    for res in s["results"]:
        got, r = res["a"], res["rank"]
        _assert_rep(got["rep"], rep_j, f"rank {r} vs JAX")
        _assert_rep(got["rep"], ref["rep"], f"rank {r} vs unsharded")
        np.testing.assert_allclose(got["latents"].numpy(), np.asarray(want), atol=2e-3,
                                   rtol=2e-3, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["latents"].numpy(), ref["latents"].numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)


def test_cfg_pair_alone_matches_jax_pair_sharding(layouts):
    """(b): the CFG pair on 2 ranks without frame sharding against JAX's
    ``guided_step_pair`` over a (data 1, cfg 2) mesh; the second data
    group's batch of 2 holds the first example as the first group does."""
    s = layouts
    mesh = make_mesh_2d(data=1, cfg=2)
    fns = j_make_fns(jcfg.micro_unet_config(), jcfg.NoiseScheduleConfig(), _infer(jcfg),
                     dtype=jnp.float32, attention_impl="xla",
                     cfg_pair_sharding=cfg_pair_sharding(mesh))
    x = s["pair_one"]
    p = shard_params(s["params"], mesh)
    with mesh:
        rep_j = fns.extract(p, x["video_latents"], x["noise"], x["uncond"], None, None)
        want = fns.sample(p, x["init"], x["uncond"], x["cond"], rep_j, None, None)
    ref = _port_unsharded(s["params"], tcfg.micro_unet_config(), x)
    firsts = [res["b"] for res in s["results"][:2]]
    for r, got in enumerate(firsts):
        _assert_rep(got["rep"], rep_j, f"rank {r} vs JAX")
        np.testing.assert_allclose(got["latents"].numpy(), np.asarray(want), atol=2e-3,
                                   rtol=2e-3, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["latents"].numpy(), ref["latents"].numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    # both halves of a pair end on the same latents
    assert torch.equal(firsts[0]["latents"], firsts[1]["latents"])
    for res in s["results"][2:]:
        batch = res["b"]["latents"]
        assert batch.shape[0] == 2
        np.testing.assert_allclose(batch[:1].numpy(), firsts[0]["latents"].numpy(),
                                   atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_sharded_controlnet_matches_jax(layouts, flavour):
    """(c): the i2v slice over 2 ranks (the controlnet's motion modules
    gather over the frame group) against JAX's frame-sharded controlnet and
    the port's unsharded run; ``sample`` without a condition is refused in
    the JAX package's words."""
    s = layouts
    jm, cn_params, tm, cond, mask, x = s["cns"][flavour]
    mesh = make_mesh_video(frames=2)
    fsh = NamedSharding(mesh, P(None, "frames"))
    cn_sharded = jsc.SparseControlNetModel(cfg=jm.cfg, frames_axis="frames",
                                           attention_impl="xla")
    fns = j_make_fns(jcfg.tiny_unet_config(), jcfg.NoiseScheduleConfig(), cn_infer(jcfg),
                     dtype=jnp.float32, attention_impl="xla",
                     controlnet_apply=make_controlnet_apply(cn_sharded), frame_shard_map=mesh)
    p, cn_p = shard_params(s["tiny_params"], mesh), shard_params(cn_params, mesh)
    j_cn = (jax.device_put(cond, fsh), jax.device_put(mask, fsh), 0.8)
    with mesh:
        rep_j = fns.extract(p, jax.device_put(x["video_latents"], fsh),
                            jax.device_put(x["noise"], fsh), x["uncond"], cn_p, j_cn)
        want = fns.sample(p, jax.device_put(x["init"], fsh), x["uncond"], x["cond"], rep_j,
                          cn_p, j_cn)
    ref = _port_unsharded(s["tiny_params"], tcfg.tiny_unet_config(), x, cn_infer(tcfg),
                          controlnet=tm, cn_cond=(_t(cond), _t(mask), 0.8))
    d = FLAVOURS.index(flavour)
    for res in s["results"][2 * d: 2 * d + 2]:
        got, r = res["c"], res["rank"]
        _assert_rep(got["rep"], rep_j, f"rank {r} vs JAX")
        _assert_rep(got["rep"], ref["rep"], f"rank {r} vs unsharded")
        np.testing.assert_allclose(got["latents"].numpy(), np.asarray(want), atol=2e-3,
                                   rtol=2e-3, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["latents"].numpy(), ref["latents"].numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=f"rank {r}")
        assert "need cn_cond on every call" in got["refused"]


def test_data_and_frames_sweep_matches_jax_data_axis(layouts):
    """(d): data group d samples example d alone; both equal JAX's batch of
    2 over a (data 2, frames 2) mesh, and each group's batch of 2 under its
    frame group equals the examples run alone."""
    s = layouts
    mesh = make_mesh_sweep(data=2, frames=2)
    vsh, esh = NamedSharding(mesh, P("data", "frames")), NamedSharding(mesh, P("data"))
    fns = j_make_fns(jcfg.micro_unet_config(), jcfg.NoiseScheduleConfig(), _infer(jcfg),
                     dtype=jnp.float32, attention_impl="xla", frame_shard_map=mesh)
    x, p = s["sweep"], shard_params(s["params"], mesh)
    with mesh:
        rep = fns.extract(p, jax.device_put(x["video_latents"], vsh),
                          jax.device_put(x["noise"], vsh), jax.device_put(x["uncond"], esh),
                          None, None)
        want = np.asarray(fns.sample(p, jax.device_put(x["init"], vsh),
                                     jax.device_put(x["uncond"], esh),
                                     jax.device_put(x["cond"], esh), rep, None, None))
    alone = [res["d_alone"] for res in s["results"]]
    for r, got in enumerate(alone):
        d = r // 2
        np.testing.assert_allclose(got.numpy(), want[d: d + 1], atol=2e-3, rtol=2e-3,
                                   err_msg=f"rank {r}")
    both = torch.cat([alone[0], alone[2]])
    for res in s["results"]:
        np.testing.assert_allclose(res["d_batch"].numpy(), both.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=f"rank {res['rank']}")


# ---------------------------------------------------------------------------
# refusals, in this process: none of them reaches a collective
# ---------------------------------------------------------------------------


def _micro_unet():
    torch.manual_seed(0)
    return TUNet(tcfg.micro_unet_config()).eval()


def test_cfg_pair_refuses_the_approx_caches():
    pair = FrameGroup(0, 2, "gloo")
    for knobs in (dict(uncond_interval=2), dict(guidance_interval=2), dict(step_interval=2)):
        with pytest.raises(ValueError, match="do not compose with CFG-pair"):
            t_make_fns(_micro_unet(), tcfg.NoiseScheduleConfig(), _infer(tcfg),
                       cfg_pair=pair, **knobs)
    with pytest.raises(ValueError, match="size 1 or 2"):
        t_make_fns(_micro_unet(), tcfg.NoiseScheduleConfig(), _infer(tcfg),
                   cfg_pair=FrameGroup(0, 4, "gloo"))


_FLAGS = ["--pretrained-model-path", "sd", "--inference_config", "i.yaml", "--examples",
          "e.jsonl", "--L", "16"]


@pytest.mark.parametrize("main, extra, world, message", [
    (cli.t2v_main, ["--frame-shard", "2"], "3", "torchrun --nproc-per-node 2"),
    (cli.t2v_main, ["--frame-shard", "2", "--cfg-pair"], "2", "torchrun --nproc-per-node 4"),
    (cli.i2v_main, ["--frame-shard", "4"], "2", "torchrun --nproc-per-node 4"),
    (cli.sweep_main, ["--frame-shard", "2", "--cfg-pair"], "6",
     "torchrun --nproc-per-node 4 \\(or a multiple"),
    (cli.serve_main, ["--frame-shard", "2"], "4", "torchrun --nproc-per-node 2"),
    (cli.t2v_main, ["--frame-shard", "3"], "3", "divide video_length=16"),
    (cli.sweep_main, ["--frame-shard", "3"], "3", "divide video_length=16"),
    (cli.t2v_main, ["--frame-shard", "2", "--device", "cpu"], "2", "pass --dist-backend gloo"),
    (cli.sweep_main, ["--cfg-pair", "--device", "cuda:1"], "4", "nccl refuses"),
])
def test_layout_flags_are_checked_before_any_file(main, extra, world, message, tmp_path,
                                                  monkeypatch):
    """A world of the wrong size, a shard count that does not divide the
    video, nccl on the CPU and nccl with every rank on one card exit
    before any file is read."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WORLD_SIZE", world)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit, match=message):
        main(_FLAGS + extra)
    assert not os.listdir(tmp_path)


def test_frame_shard_one_runs_unsharded(capsys):
    """As in the JAX package: --frame-shard 1 (with or without --cfg-pair)
    is a no-op, for the CLIs that take one video's layout and the sweep."""
    for main in (cli.t2v_main, cli.sweep_main):
        args = cli.build_parser("a.yaml", "b.jsonl").parse_args(
            ["--frame-shard", "1", "--device", "cpu", "--dist-backend", "gloo"]
            + (["--cfg-pair"] if main is cli.t2v_main else []))
        args.num_processes = 0
        cli._check_flags(args, sweep=main is cli.sweep_main)
        assert (args.frame_shard, args.cfg_pair) == (0, False)
    out = capsys.readouterr().out
    assert "frame-shard 1 is a no-op" in out and "frame_shard=1 is a no-op" in out


# ---------------------------------------------------------------------------
# the CLIs under 2 gloo ranks, against their unsharded runs
# ---------------------------------------------------------------------------

SD = os.path.join("models", "SD")
PROMPT = "a cat running"
BASE = ["--pretrained-model-path", SD, "--motion-representation-save-dir", "reps",
        "--W", "64", "--H", "64", "--L", "4", "--float32", "--device", "cpu"]
LAYOUT = ["--frame-shard", "2", "--dist-backend", "gloo"]
JOB = {"video_path": "ref.mp4", "new_prompt": PROMPT, "seed": 42}


def _argv(which, out, reps="reps"):
    if which == "i2v":
        cfg, examples = "inference_i2v.yaml", "examples_i2v.jsonl"
    else:
        cfg, examples = "inference.yaml", "examples.jsonl"
    return BASE + ["--inference_config", cfg, "--examples", examples,
                   "--generated-videos-save-dir", out, "--motion-representation-save-dir",
                   reps]


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """tests/test_torch_runtime.py's model directory, its RGB controlnet,
    a reference clip and a condition PNG."""
    import yaml
    from PIL import Image

    root = str(tmp_path_factory.mktemp("layout_clis"))
    _build_model_dir(root)
    cn_path = _build_controlnet(root, "latent")
    with open(os.path.join(root, "inference.yaml")) as f:
        infer = yaml.safe_load(f)
    infer.update(controlnet_path=os.path.relpath(cn_path, root),
                 controlnet_config="sparsectrl_latent.yaml", controlnet_scale=0.9)
    with open(os.path.join(root, "inference_i2v.yaml"), "w") as f:
        yaml.safe_dump(infer, f)
    frames = np.random.default_rng(0).integers(0, 255, size=(6, 64, 64, 3), dtype=np.uint8)
    write_video(os.path.join(root, "ref.mp4"), frames, fps=8)
    img = np.random.default_rng(1).integers(0, 255, size=(48, 64, 3), dtype=np.uint8)
    Image.fromarray(img).save(os.path.join(root, "cond.png"))
    with open(os.path.join(root, "examples.jsonl"), "w") as f:
        f.write(json.dumps(JOB) + "\n")
    with open(os.path.join(root, "examples_i2v.jsonl"), "w") as f:
        f.write(json.dumps(dict(JOB, condition_image_paths=["cond.png"],
                                image_index=[1])) + "\n")
    return root


@pytest.fixture(scope="module")
def cli_ranks(cli_dir):
    argvs = {"t2v": _argv("t2v", "out_t2v", "reps_t2v") + LAYOUT + ["--weights-cache", "wc"],
             "i2v": _argv("i2v", "out_i2v", "reps_i2v") + LAYOUT,
             "sweep": _argv("t2v", "out_sweep", "reps_sweep") + LAYOUT + ["--num-devices", "1"],
             "sweep_pair": _argv("t2v", "out_sweep_pair", "reps_sweep_pair")
             + ["--cfg-pair", "--dist-backend", "gloo"],
             "serve": _argv("t2v", "out_serve", "reps_serve") + LAYOUT
             + ["--port", "0", "--batch-max", "2"]}
    return launch(clis_rank, 2, backend="gloo", args=(cli_dir, argvs, JOB),
                  timeout=LAUNCH_TIMEOUT_S)


@pytest.fixture(scope="module")
def cli_unsharded(cli_dir):
    """The unsharded t2v and i2v CLI runs: their mp4 and final latents."""
    cwd = os.getcwd()
    os.chdir(cli_dir)
    seen = []
    sample = MotionClonePipeline.sample_latents

    def spy(self, *args, **kwargs):
        seen.append(sample(self, *args, **kwargs))
        return seen[-1]

    MotionClonePipeline.sample_latents = spy
    try:
        out = {}
        for which, main in (("t2v", cli.t2v_main), ("i2v", cli.i2v_main)):
            _, paths = main(_argv(which, f"out_{which}_ref", f"reps_{which}_ref"))
            out[which] = (paths, seen[-1])
    finally:
        MotionClonePipeline.sample_latents = sample
        os.chdir(cwd)
    return out


def _frames(path):
    return read_video_frames(path)[0].astype(np.int16)


@pytest.mark.parametrize("which", ["t2v", "i2v", "sweep", "sweep_pair", "serve"])
def test_cli_under_two_ranks_writes_the_unsharded_video(cli_dir, cli_ranks, cli_unsharded,
                                                        which):
    """Each CLI under ``--frame-shard 2`` (the sweep also under
    ``--cfg-pair`` alone: the (data, cfg) layout) writes one mp4 (rank 0),
    under the unsharded run's name, whose latents every rank gathered equal
    to the unsharded run's and whose frames equal its frames within one
    level."""
    ref_paths, ref_latents = cli_unsharded["i2v" if which == "i2v" else "t2v"]
    out_dir = os.path.join(cli_dir, f"out_{which}")
    assert sorted(p for p in os.listdir(out_dir) if p.endswith(".mp4")) == \
        [os.path.basename(ref_paths[0])]
    for res in cli_ranks:
        if which == "serve":
            latents = res["serve_latents"]
            if res["rank"] == 0:
                rec = res["serve"]
                assert rec["joined"] and rec["record"]["status"] == "done", rec
                assert rec["record"]["output_path"] == os.path.join(
                    "out_serve", os.path.basename(ref_paths[0]))
        else:
            assert res[which]["paths"] == [os.path.join(f"out_{which}",
                                                        os.path.basename(ref_paths[0]))]
            latents = res[which]["latents"]
        np.testing.assert_allclose(latents.numpy(), ref_latents.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=f"rank {res['rank']}")
    got = _frames(os.path.join(out_dir, os.path.basename(ref_paths[0])))
    want = _frames(os.path.join(cli_dir, ref_paths[0]))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def test_weights_cache_is_written_by_rank_zero_alone(cli_ranks):
    """Rank 0 misses and writes the entry; rank 1 waits for it and hits;
    both hold the same parameters bit for bit."""
    t2v = [res["t2v"] for res in cli_ranks]
    assert [r["cache"] for r in t2v] == ["miss", "hit"]
    assert t2v[0]["checksum"] == t2v[1]["checksum"]
