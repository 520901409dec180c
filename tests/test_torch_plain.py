"""The port's plain generation and its ``save_probs`` dump against the JAX
package, on the CPU in f32.

* the micro UNet (4 frames, 16x16 latents, 4 "leading" steps, cfg 7.5)
  with random fan-in-scaled flax parameters carried into the port by
  ``weights/from_jax.py``, the same numpy latents and embeddings on both
  sides, JAX on its exact ``attention_impl="xla"`` path: ``sample_plain``
  exact, under the uncond and step caches (uncond_interval 2,
  step_interval 2, step_extrap 0.5, chunks of 3) and with a SparseCtrl
  controlnet (tests/test_torch_sparse_controlnet.py's tiny UNet and RGB
  controlnet) at atol and rtol 2e-3, the tolerance of
  tests/test_torch_pipeline.py's slice; the plain timesteps equal JAX's
  "leading" ones;
* ``sample_plain_probs``: the same keys and shapes as JAX's, the
  probabilities within atol 1e-5 and rtol 1e-4 (the two f32 forwards part
  by up to 1.5e-5 at probabilities near 0.6 from the first step on) and
  the latents within 2e-3;
* ``MotionClonePipeline.sample_latents_plain(save_probs_path=...)``: the
  file holds the returned maps, and the latents are the undumped run's
  within 2e-5 (tests/test_pipeline_tiny.py's bound: the dumped modules take
  the plain probability route);
* under 2 gloo ranks: the frame group's gathered dump and latents equal the
  unsharded run's (tests/test_torch_frame_shard.py's tolerances against
  the unsharded port), and a CFG pair's dump has the unpaired run's rows."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu import config as jcfg
from motionclone_tpu.diffusion.ddim import build_timesteps as j_build_timesteps
from motionclone_tpu.models import sparse_controlnet as jsc
from motionclone_tpu.models.unet3d import UNet3DConditionModel as JUNet
from motionclone_tpu.pipeline.motionclone import (
    make_controlnet_apply,
    make_sampling_fns as j_make_fns,
)
from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.models import sparse_controlnet as tsc
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel as TUNet
from motionclone_tpu_torch.parallel.frames import launch
from motionclone_tpu_torch.pipeline.motionclone import (
    MotionClonePipeline,
    make_sampling_fns as t_make_fns,
)
from motionclone_tpu_torch.weights.from_jax import state_dict_from_flax
from test_sparse_controlnet import tiny_cn_config
from test_torch_layouts_ranks import plain_probs_rank
from test_torch_models import load_port, one_torch_thread, random_flax_params  # noqa: F401
from test_torch_sparse_controlnet import _build, unet_pair  # noqa: F401

GUIDANCE = ("up_blocks.1",)
B, F_, HW = 1, 4, 16
APPROX = dict(uncond_interval=2, step_interval=2, step_extrap=0.5)
LAUNCH_TIMEOUT_S = 240.0

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(x):
    return torch.from_numpy(np.array(x))


def _infer(mod):
    return mod.InferenceConfig(
        inference_steps=4, guidance_steps=2, guidance_fraction=0.3,
        warm_up_steps=1, cool_up_steps=1, motion_guidance_weight=50.0,
        motion_guidance_blocks=GUIDANCE, add_noise_step=400,
        cfg_scale=7.5, width=HW * 8, height=HW * 8, video_length=F_,
    )


@pytest.fixture(scope="module")
def s():
    r = np.random.default_rng(30)
    init = r.standard_normal((B, F_, HW, HW, 4)).astype(np.float32)
    uncond, cond = (r.standard_normal((B, 7, 16)).astype(np.float32) for _ in range(2))
    jm = JUNet(cfg=jcfg.micro_unet_config(), guidance_blocks=GUIDANCE, attention_impl="xla")
    params = random_flax_params(jm, init, jnp.zeros((1,), jnp.int32), uncond, seed=31)
    unet = load_port(TUNet(tcfg.micro_unet_config()), params)
    sched = tcfg.NoiseScheduleConfig()
    fns = t_make_fns(unet, sched, _infer(tcfg))
    return dict(params=params, unet=unet, fns=fns, init=init, uncond=uncond, cond=cond,
                args=(_t(init), _t(uncond), _t(cond)),
                fns_j=j_make_fns(jcfg.micro_unet_config(), jcfg.NoiseScheduleConfig(),
                                 _infer(jcfg), dtype=jnp.float32, attention_impl="xla"),
                plain=fns.sample_plain(_t(init), _t(uncond), _t(cond)))


def _jax_args(s):
    return s["params"], s["init"], s["uncond"], s["cond"]


def test_plain_timesteps_are_jax_leading_ones(s):
    sched = jcfg.NoiseScheduleConfig()
    want = j_build_timesteps(4, sched.num_train_timesteps, steps_offset=sched.steps_offset,
                             spacing="leading")
    np.testing.assert_array_equal(s["fns"].plain_timesteps, want)
    assert s["fns"].plain_timesteps.tolist() == [751, 501, 251, 1]
    # not the guided schedule's "uneven" spacing
    assert s["fns"].plain_timesteps.tolist() != s["fns"].timesteps.tolist()


def test_sample_plain_matches_jax(s):
    want = s["fns_j"].sample_plain(*_jax_args(s))
    steps = []
    got = s["fns"].sample_plain(*s["args"], on_step=lambda i, g: steps.append((i, g)))
    assert steps == [(i, False) for i in range(4)]
    torch.testing.assert_close(got, s["plain"], rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


def test_sample_plain_under_the_caches_matches_jax(s):
    fns_j = j_make_fns(jcfg.micro_unet_config(), jcfg.NoiseScheduleConfig(), _infer(jcfg),
                       dtype=jnp.float32, attention_impl="xla", **APPROX)
    want = fns_j.sample_plain(*_jax_args(s), chunk_steps=3)
    fns = t_make_fns(s["unet"], tcfg.NoiseScheduleConfig(), _infer(tcfg), **APPROX)
    got = fns.sample_plain(*s["args"], chunk_steps=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)
    # chunk-relative flags: a full step, a skip, a full step on the stale
    # uncond prediction, then the second chunk's fresh start
    sched = fns.schedule(chunk_steps=3, plain=True)
    assert sched.full.tolist() == [True, False, True, True]
    assert sched.uncond.tolist() == [True, False, False, True]
    assert (got - s["plain"]).abs().max() > 1e-3  # the caches move the result


def test_sample_plain_with_a_controlnet_matches_jax(unet_pair):  # noqa: F811
    jm, params, tm = unet_pair
    cn_cfg = dataclasses.replace(tiny_cn_config(simplified=True),
                                 set_noisy_sample_input_to_zero=False)
    jcn, cn_params, tcn = _build(cn_cfg, seed=32)
    r = np.random.default_rng(33)
    init = r.standard_normal((B, F_, HW, HW, 4)).astype(np.float32)
    uncond, cond = (r.standard_normal((B, 7, 16)).astype(np.float32) for _ in range(2))
    frames = r.standard_normal((B, 1, HW, HW, 4)).astype(np.float32)
    j_cond, j_mask = jsc.scatter_condition(jnp.asarray(frames), (0,), F_)
    t_cond, t_mask = tsc.scatter_condition(_t(frames), (0,), F_)
    fns_j = j_make_fns(jcfg.tiny_unet_config(), jcfg.NoiseScheduleConfig(), _infer(jcfg),
                       dtype=jnp.float32, attention_impl="xla",
                       controlnet_apply=make_controlnet_apply(jcn))
    fns = t_make_fns(tm, tcfg.NoiseScheduleConfig(), _infer(tcfg), controlnet=tcn)
    want = fns_j.sample_plain(params, init, uncond, cond, cn_params, (j_cond, j_mask, 0.8))
    got = fns.sample_plain(_t(init), _t(uncond), _t(cond), (t_cond, t_mask, 0.8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)
    unconditioned = fns.sample_plain(_t(init), _t(uncond), _t(cond))
    assert (got - unconditioned).abs().max() > 1e-2


@pytest.fixture(scope="module")
def probs(s):
    return s["fns"].sample_plain_probs(*s["args"], chunk_steps=3)


def test_sample_plain_probs_matches_jax(s, probs):
    want_lat, want = s["fns_j"].sample_plain_probs(*_jax_args(s), chunk_steps=3)
    got_lat, got = probs
    # up_blocks.1 of the micro UNet: 2 motion modules x 2 attention blocks
    assert sorted(got) == sorted(want) and len(got) == 4
    for k, v in got.items():
        # (steps, the CFG pair, S, heads, query frames, key frames)
        assert v.dtype == np.float32 and v.shape == want[k].shape
        assert v.shape[:2] == (4, 2 * B) and v.shape[-2:] == (F_, F_)
        np.testing.assert_allclose(v, want[k], atol=1e-5, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(v.sum(-1), 1.0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), atol=2e-3, rtol=2e-3)


def test_save_probs_writes_the_maps_and_keeps_the_latents(s, tmp_path):
    pipe = MotionClonePipeline(tcfg.micro_unet_config(), tcfg.NoiseScheduleConfig(),
                               _infer(tcfg), s["unet"], device="cpu", dtype=torch.float32)
    uncond, cond = _t(s["uncond"]), _t(s["cond"])
    path = str(tmp_path / "probs.npz")
    out = pipe.sample_latents_plain(uncond, cond, seed=13, save_probs_path=path)
    ref = pipe.sample_latents_plain(uncond, cond, seed=13)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    lat, want = pipe.fns.sample_plain_probs(pipe.initial_latents(13), uncond, cond)
    torch.testing.assert_close(lat, out, rtol=0, atol=0)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(want)
        for k in data.files:
            np.testing.assert_array_equal(data[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def ranks(s):
    """One launch of 2 gloo ranks (test_torch_layouts_ranks.py's
    ``plain_probs_rank``): the frame group's and the CFG pair's dumps."""
    return launch(plain_probs_rank, 2, backend="gloo", timeout=LAUNCH_TIMEOUT_S,
                  args=(state_dict_from_flax(s["params"]), tcfg.micro_unet_config(),
                        tcfg.NoiseScheduleConfig(), _infer(tcfg), *s["args"]))


@pytest.mark.parametrize("layout", ["frames", "pair"])
def test_dump_under_two_ranks_is_the_unsharded_one(s, probs, ranks, layout):
    want_lat, want = probs
    for r, res in enumerate(ranks):
        lat, got = res[layout]
        assert sorted(got) == sorted(want), f"rank {r}"
        for k, v in got.items():
            assert v.shape == want[k].shape, f"rank {r} {k}"
            np.testing.assert_allclose(v, want[k], atol=2e-5, rtol=1e-4,
                                       err_msg=f"{layout} rank {r} {k}")
        np.testing.assert_allclose(lat.numpy(), want_lat.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=f"{layout} rank {r}")


def test_chip_smoke_predicts_the_probs_route_at_sd15_width():
    """chip_smoke.py's ``predicted_probs_launches`` at 512x512x16f, SD1.5
    width (the model on the meta device): the three motion modules of
    up_blocks.1 (1280 channels: no kernel 7) leave kernel 3's 6 launches a
    step for the plain probability route; the rest is a vanilla step's."""
    import os
    import sys
    from types import SimpleNamespace

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    with torch.device("meta"):
        unet = TUNet(tcfg.UNet3DConfig())
    pipe = SimpleNamespace(unet=unet, unet_cfg=unet.cfg, infer_cfg=chip_smoke.t2v_config())
    want = {name: 4 * per_v for name, (_, _, per_v) in chip_smoke.PREDICTED_LAUNCHES.items()}
    want["temporal_fwd"] -= 4 * 6
    assert chip_smoke.predicted_probs_launches(pipe, 4) == want
