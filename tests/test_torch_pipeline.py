"""The port's guided t2v slice vs the JAX package, on the CPU in f32.

* DDIM and guidance functions one to one (the cases of tests/test_ddim.py
  and tests/test_guidance.py), exact up to f32 rounding;
* the micro UNet's ``extract`` (values to 1e-5, uint8 indices equal) and
  ``sample`` with 2 guided + 2 vanilla steps (tolerance 2e-3, as the torch
  oracle of tests/test_torch_oracle_unet.py) against
  ``make_sampling_fns(..., dtype=jnp.float32, attention_impl="xla")``, on
  the same numpy noise, latents, embeddings and weights;
* the fused path: 1 guided + 1 vanilla step with ``attention_impl="fused"``
  (the fused modules' plain versions) on a micro UNet widened so that every
  resnet, spatial transformer and motion module routes to kernels 5, 7 and
  8, against JAX's ``attention_impl="fused"`` (Pallas interpret mode) with
  ``guided_attention_impl="xla"``, at 2e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu import config as jcfg
from motionclone_tpu.diffusion import ddim as jddim
from motionclone_tpu.diffusion import guidance as jguid
from motionclone_tpu.models.unet3d import UNet3DConditionModel as JUNet
from motionclone_tpu.pipeline.motionclone import make_sampling_fns as j_make_fns
from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.diffusion import ddim as tddim
from motionclone_tpu_torch.diffusion import guidance as tguid
from motionclone_tpu_torch.models.attention import Transformer3DModel
from motionclone_tpu_torch.models.motion_module import TemporalTransformer3D
from motionclone_tpu_torch.models.resnet import ResnetBlock3D
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel as TUNet
from motionclone_tpu_torch.ops import fused_block, fused_resnet, fused_temporal
from motionclone_tpu_torch.pipeline.motionclone import (
    MotionClonePipeline,
    make_sampling_fns as t_make_fns,
    resolve_impl,
)
from test_torch_models import load_port, one_torch_thread, random_flax_params  # noqa: F401

GUIDANCE = ("up_blocks.1",)
F_, HW = 4, 16

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# ddim / guidance one to one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["linear", "scaled_linear", "squaredcos_cap_v2"])
def test_betas_and_params(schedule):
    j = jcfg.NoiseScheduleConfig(beta_schedule=schedule)
    t = tcfg.NoiseScheduleConfig(beta_schedule=schedule)
    np.testing.assert_array_equal(tddim.make_betas(t), jddim.make_betas(j))
    np.testing.assert_array_equal(
        tddim.make_ddim_params(t).alphas_cumprod.numpy(),
        np.asarray(jddim.make_ddim_params(j).alphas_cumprod),
    )


@pytest.mark.parametrize("spacing", ["uneven", "linspace", "leading", "trailing"])
def test_timesteps(spacing):
    args = (100, 1000, 50, 0.3, 1, spacing)
    ts = tddim.build_timesteps(*args)
    np.testing.assert_array_equal(ts, jddim.build_timesteps(*args))
    np.testing.assert_array_equal(tddim.prev_timesteps(ts), jddim.prev_timesteps(ts))


def test_add_noise_and_variance():
    r = np.random.default_rng(0)
    x0, eps = r.standard_normal((2, 3, 4, 4, 4), dtype=np.float32), \
        r.standard_normal((2, 3, 4, 4, 4), dtype=np.float32)
    pj = jddim.make_ddim_params(jcfg.NoiseScheduleConfig())
    pt = tddim.make_ddim_params(tcfg.NoiseScheduleConfig())
    np.testing.assert_allclose(tddim.add_noise(pt, 400, _t(x0), _t(eps)).numpy(),
                               np.asarray(jddim.add_noise(pj, 400, x0, eps)),
                               atol=1e-6)
    for t, tp in ((981, 961), (20, -1), (500, 480)):
        np.testing.assert_allclose(float(tddim.ddim_variance(pt, t, tp)),
                                   float(jddim.ddim_variance(pj, t, tp)), rtol=1e-6)


@pytest.mark.parametrize("case", [
    "epsilon", "sample", "v_prediction", "score", "final", "eta", "clip",
    "thresholding",
])
def test_ddim_step(case):
    r = np.random.default_rng(1)
    shape = (2, 3, 4, 4, 4)
    model_out, sample, score, noise = (
        r.standard_normal(shape).astype(np.float32) * 2 for _ in range(4)
    )
    kw = {}
    sched = {}
    t, tp = 801, 781
    if case in ("sample", "v_prediction"):
        sched["prediction_type"] = case
    if case == "score":
        kw = dict(score=score, guidance_scale=0.7)
    if case == "final":
        t, tp = 21, -1
    if case == "eta":
        kw = dict(eta=0.5, variance_noise=noise)
    if case == "clip":
        sched["clip_sample"] = True
    if case == "thresholding":
        sched.update(thresholding=True, sample_max_value=2.0)
    pj = jddim.make_ddim_params(jcfg.NoiseScheduleConfig(**sched))
    pt = tddim.make_ddim_params(tcfg.NoiseScheduleConfig(**sched))
    want = jddim.ddim_step(pj, model_out, t, tp, sample,
                           **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                              for k, v in kw.items()})
    got = tddim.ddim_step(pt, _t(model_out), t, tp, _t(sample),
                          **{k: (_t(v) if isinstance(v, np.ndarray) else v)
                             for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_sparsify_gather_loss_ramps():
    r = np.random.default_rng(2)
    logits = r.standard_normal((2, 5, 2, 8, 8)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    vj, ij = jguid.sparsify_top1(probs)
    vt, it = tguid.sparsify_top1(_t(probs))
    assert it.dtype == torch.uint8
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(
        tguid.gather_sparse_probs(_t(probs), it).numpy(),
        np.asarray(jguid.gather_sparse_probs(probs, ij)),
    )
    other = np.asarray(jax.nn.softmax(logits * 1.5, axis=-1))
    cur_j = {"b": other, "a": other[::-1].copy()}
    rep_j = {"a": (vj, ij), "b": (vj, ij)}
    want = jguid.motion_guidance_loss(cur_j, rep_j)
    got = tguid.motion_guidance_loss(
        {k: _t(v) for k, v in cur_j.items()},
        {k: (vt, it) for k in rep_j},
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for args in ((50, 10, 10), (2, 1, 1), (5, 0, 3)):
        np.testing.assert_array_equal(tguid.ramp_scales(*args),
                                      jguid.ramp_scales(*args))


# ---------------------------------------------------------------------------
# the slice: extraction and 2 guided + 2 vanilla steps on the micro UNet
# ---------------------------------------------------------------------------


def _infer(mod):
    return mod.InferenceConfig(
        inference_steps=4, guidance_steps=2, guidance_fraction=0.3,
        warm_up_steps=1, cool_up_steps=1, motion_guidance_weight=50.0,
        motion_guidance_blocks=GUIDANCE, add_noise_step=400,
        cfg_scale=7.5, width=HW * 8, height=HW * 8, video_length=F_,
    )


@pytest.fixture(scope="module")
def slice_setup():
    r = np.random.default_rng(20)
    shape = (1, F_, HW, HW, 4)
    video_latents, extract_noise, init_latents = (
        r.standard_normal(shape).astype(np.float32) for _ in range(3)
    )
    uncond, cond = (r.standard_normal((1, 7, 16)).astype(np.float32) for _ in range(2))
    jm = JUNet(cfg=jcfg.micro_unet_config(), guidance_blocks=GUIDANCE,
               attention_impl="xla")
    params = random_flax_params(jm, video_latents, jnp.zeros((1,), jnp.int32),
                                uncond, seed=21)
    unet_t = load_port(TUNet(tcfg.micro_unet_config()), params)
    fns_j = j_make_fns(jcfg.micro_unet_config(), jcfg.NoiseScheduleConfig(),
                       _infer(jcfg), dtype=jnp.float32, attention_impl="xla")
    fns_t = t_make_fns(unet_t, tcfg.NoiseScheduleConfig(), _infer(tcfg))
    rep_j = fns_j.extract(params, video_latents, extract_noise, uncond)
    rep_t = fns_t.extract(_t(video_latents), _t(extract_noise), _t(uncond))
    return dict(params=params, fns_j=fns_j, fns_t=fns_t, rep_j=rep_j,
                rep_t=rep_t, init=init_latents, uncond=uncond, cond=cond,
                unet_t=unet_t)


def test_extract_matches_jax(slice_setup):
    rep_j, rep_t = slice_setup["rep_j"], slice_setup["rep_t"]
    assert sorted(rep_t) == sorted(rep_j) and len(rep_t) == 4
    for k in rep_t:
        np.testing.assert_allclose(rep_t[k][0].numpy(), np.asarray(rep_j[k][0]),
                                   atol=1e-5, rtol=0, err_msg=k)
        assert rep_t[k][1].dtype == torch.uint8
        np.testing.assert_array_equal(rep_t[k][1].numpy(), np.asarray(rep_j[k][1]),
                                      err_msg=k)


def test_two_guided_two_vanilla_steps_match_jax(slice_setup):
    s = slice_setup
    want = s["fns_j"].sample(s["params"], s["init"], s["uncond"], s["cond"],
                             s["rep_j"])
    steps = []
    got = s["fns_t"].sample(_t(s["init"]), _t(s["uncond"]), _t(s["cond"]),
                            s["rep_t"], on_step=lambda i, g: steps.append((i, g)))
    assert steps == [(0, True), (1, True), (2, False), (3, False)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


def test_pipeline_entry_point_on_cpu(slice_setup):
    """``MotionClonePipeline(device="cpu")`` drives extraction and sampling
    from seeds; the motion guidance moves the result."""
    s = slice_setup
    pipe = MotionClonePipeline(
        tcfg.micro_unet_config(), tcfg.NoiseScheduleConfig(), _infer(tcfg),
        s["unet_t"], device="cpu", dtype=torch.float32,
    )
    rep = pipe.extract_motion_representation(_t(s["init"]), _t(s["uncond"]), seed=3)
    out = pipe.sample_latents(_t(s["uncond"]), _t(s["cond"]), rep, seed=4)
    assert out.shape == (1, F_, HW, HW, 4) and torch.isfinite(out).all()


def test_post_guidance_cut_changes_no_value_or_gradient():
    """Up blocks after the cut run under no_grad: the noise prediction, the
    guidance probabilities and the loss gradient are those of the plain
    forward (tiny UNet: up blocks 2 and 3 are cut)."""
    torch.manual_seed(0)
    unet = TUNet(tcfg.tiny_unet_config()).eval()
    for p in unet.parameters():  # no zero-initialised projection
        torch.nn.init.normal_(p, 0.0, 0.2)
    x = torch.randn(1, F_, HW, HW, 4)
    ctx = torch.randn(1, 7, 16)
    results = []
    for cut in (None, 1):
        leaf = x.clone().requires_grad_(True)
        pred, probs = unet(leaf, 600, ctx, guidance_blocks=GUIDANCE,
                           post_guidance_cut=cut)
        loss = sum(p.square().sum() for p in probs.values())
        (grad,) = torch.autograd.grad(loss, leaf)
        results.append((pred.detach(), grad))
    assert not results[1][0].requires_grad
    torch.testing.assert_close(results[1][0], results[0][0], rtol=0, atol=0)
    torch.testing.assert_close(results[1][1], results[0][1], rtol=0, atol=0)


def test_pipeline_text_and_vae_helpers_on_cpu():
    from motionclone_tpu_torch.models.clip_text import CLIPTextModel, tiny_clip_config
    from motionclone_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config

    torch.manual_seed(1)
    infer = tcfg.InferenceConfig(inference_steps=2, guidance_steps=1, width=32,
                                 height=32, video_length=F_)
    cfg = tcfg.micro_unet_config()
    pipe = MotionClonePipeline(
        cfg, tcfg.NoiseScheduleConfig(), infer, TUNet(cfg),
        vae=AutoencoderKL(tiny_vae_config()),
        text_encoder=CLIPTextModel(tiny_clip_config()),
        device="cpu", dtype=torch.float32,
    )
    emb = pipe.encode_text(torch.randint(0, 64, (2, 77)))
    assert emb.shape == (2, 77, 16)
    video = torch.rand(F_, 32, 32, 3) * 2 - 1
    latents = pipe.encode_video(video, seed=0)
    assert latents.shape == (1, F_, 16, 16, 4)
    # the posterior draw is seeded
    torch.testing.assert_close(pipe.encode_video(video, seed=0), latents)
    frames = pipe.decode_latents(latents)
    assert frames.shape == (F_, 32, 32, 3) and torch.isfinite(frames).all()


# ---------------------------------------------------------------------------
# the fused path: 1 guided + 1 vanilla step against JAX's fused routing
# ---------------------------------------------------------------------------

FUSED_F, FUSED_HW = 8, 16


def _fused_cfg(mod):
    """The micro UNet at channels (32, 64), 2 heads (head dims 16 / 32) and 8
    groups: at 8 frames and 16x16 latents every resnet, spatial transformer
    and motion module passes the fused routing predicates."""
    cfg = mod.micro_unet_config()
    return dataclasses.replace(
        cfg, block_out_channels=(32, 64), norm_num_groups=8,
        motion_module=dataclasses.replace(cfg.motion_module, norm_num_groups=8))


def _fused_infer(mod):
    return mod.InferenceConfig(
        inference_steps=2, guidance_steps=1, guidance_fraction=0.3,
        warm_up_steps=0, cool_up_steps=0, motion_guidance_weight=50.0,
        motion_guidance_blocks=GUIDANCE, add_noise_step=400, cfg_scale=7.5,
        width=FUSED_HW * 8, height=FUSED_HW * 8, video_length=FUSED_F,
    )


def test_auto_impl_is_unfused_on_cpu():
    assert resolve_impl("auto", torch.device("cpu")) == "flash"
    assert resolve_impl("auto", torch.device("cuda")) == "fused"
    assert resolve_impl("fused", torch.device("cpu")) == "fused"
    with pytest.raises(ValueError):
        resolve_impl("xla", torch.device("cpu"))


def test_fused_guided_and_vanilla_steps_match_jax(monkeypatch):
    r = np.random.default_rng(30)
    shape = (1, FUSED_F, FUSED_HW, FUSED_HW, 4)
    video_latents, extract_noise, init_latents = (
        r.standard_normal(shape).astype(np.float32) for _ in range(3)
    )
    uncond, cond = (r.standard_normal((1, 7, 16)).astype(np.float32) for _ in range(2))
    jm = JUNet(cfg=_fused_cfg(jcfg), guidance_blocks=GUIDANCE, attention_impl="xla")
    params = random_flax_params(jm, video_latents, jnp.zeros((1,), jnp.int32),
                                uncond, seed=31)
    unet_t = load_port(TUNet(_fused_cfg(tcfg)), params)
    fns_j = j_make_fns(_fused_cfg(jcfg), jcfg.NoiseScheduleConfig(), _fused_infer(jcfg),
                       dtype=jnp.float32, attention_impl="fused",
                       guided_attention_impl="xla")
    fns_t = t_make_fns(unet_t, tcfg.NoiseScheduleConfig(), _fused_infer(tcfg),
                       attention_impl="fused")
    rep_j = fns_j.extract(params, video_latents, extract_noise, uncond)
    rep_t = fns_t.extract(_t(video_latents), _t(extract_noise), _t(uncond))
    want = fns_j.sample(params, init_latents, uncond, cond, rep_j)

    calls = {}
    for mod, name in ((fused_resnet, "fused_resnet_block_plain"),
                      (fused_block, "fused_spatial_transformer_plain"),
                      (fused_temporal, "fused_temporal_module_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **k:
                            calls.__setitem__(_n, calls.get(_n, 0) + 1) or _f(*a, **k))
    got = fns_t.sample(_t(init_latents), _t(uncond), _t(cond), rep_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)
    # every module of the guided step's unconditional pass and of the
    # vanilla pass took its fused route (no up block lies past the cut)
    count = lambda cls: sum(isinstance(m, cls) for m in unet_t.modules())
    assert calls == {
        "fused_resnet_block_plain": 2 * count(ResnetBlock3D),
        "fused_spatial_transformer_plain": 2 * count(Transformer3DModel),
        "fused_temporal_module_plain": 2 * count(TemporalTransformer3D),
    }
