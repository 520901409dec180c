"""The port's SparseCtrl slice against the JAX package, on the CPU in f32.

Tiny models (tests/test_sparse_controlnet.py's ``tiny_cn_config`` on the
tiny UNet3D), random fan-in-scaled flax parameters (no zero-initialised
head hides a path) carried into the port by ``weights/from_jax.py``, the
same numpy inputs on both sides, JAX on its exact ``attention_impl="xla"``
path:

* the controlnet's down and mid residuals, both flavours (the simplified
  latent embedding of the RGB workload, the pixel conv stack of the
  sketch workload), at atol and rtol 1e-4 (f32 through the conv stack and
  the down half, outputs of a few units); with
  ``set_noisy_sample_input_to_zero`` they do not depend on the latents,
  conv_in's bias broadcast is conv_in of zeros, and the scale multiplies;
* ``scatter_condition`` exactly;
* the UNet with given residuals (noise prediction and probabilities),
  atol 1e-4;
* extraction with a condition and 2 guided + 2 vanilla steps against
  ``make_sampling_fns(controlnet_apply=make_controlnet_apply(...))``: the
  motion representation's values at 1e-5 with equal indices, the latents
  at 2e-3, as tests/test_torch_pipeline.py holds the t2v slice.  The
  controlnet here reads the latents (``set_noisy_sample_input_to_zero``
  off), so a gradient through it would move the guided steps off JAX's;
* a controlnet under a frame group of two ranks refuses a call without
  ``cn_cond`` (the JAX package's ``_check_smap_cn_cond``) or with a
  condition of the rank's frames only."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionclone_tpu import config as jcfg
from motionclone_tpu.models import sparse_controlnet as jsc
from motionclone_tpu.models.unet3d import UNet3DConditionModel as JUNet
from motionclone_tpu.pipeline.motionclone import (
    make_controlnet_apply,
    make_sampling_fns as j_make_fns,
)
from motionclone_tpu_torch import config as tcfg
from motionclone_tpu_torch.models import sparse_controlnet as tsc
from motionclone_tpu_torch.models.layers import spatial_conv
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel as TUNet
from motionclone_tpu_torch.parallel.frames import FrameGroup
from motionclone_tpu_torch.pipeline.motionclone import make_sampling_fns as t_make_fns
from test_sparse_controlnet import tiny_cn_config
from test_torch_models import (  # noqa: F401
    close, load_port, one_torch_thread, random_flax_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F_, HW = 1, 4, 16
GUIDANCE = ("up_blocks.1",)
FLAVOURS = ("latent", "pixel")  # configs/i2v_rgb.yaml, configs/i2v_sketch.yaml

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_cfg(jax_cfg):
    """The port's SparseControlNetConfig with the fields of the JAX one."""
    d = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    d["motion_module"] = tcfg.MotionModuleConfig(**dataclasses.asdict(jax_cfg.motion_module))
    return tsc.SparseControlNetConfig(**d)


def _cond_shape(cfg, batch=B):
    side = HW * (1 if cfg.use_simplified_condition_embedding else
                 2 ** (len(cfg.conditioning_embedding_out_channels) - 1))
    return (batch, F_, side, side, cfg.conditioning_channels)


def _build(jax_cfg, seed):
    """(JAX model, its random parameters, the port model loaded with them)."""
    jm = jsc.SparseControlNetModel(cfg=jax_cfg, attention_impl="xla")
    shape = _cond_shape(jax_cfg)
    params = random_flax_params(
        jm, jnp.zeros((B, F_, HW, HW, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 7, 16)), jnp.zeros(shape), jnp.zeros(shape[:-1] + (1,)), seed=seed)
    return jm, params, load_port(tsc.SparseControlNetModel(_port_cfg(jax_cfg)), params)


@pytest.fixture(scope="module")
def models():
    return {flavour: _build(tiny_cn_config(simplified=flavour == "latent"), seed=40 + i)
            for i, flavour in enumerate(FLAVOURS)}


def _inputs(cfg, seed):
    r = np.random.default_rng(seed)
    sample = r.standard_normal((B, F_, HW, HW, 4)).astype(np.float32)
    ctx = r.standard_normal((1, 7, 16)).astype(np.float32)
    shape = _cond_shape(cfg)
    frames = r.standard_normal((B, 2) + shape[2:]).astype(np.float32)
    cond, mask = jsc.scatter_condition(jnp.asarray(frames), (0, 3), F_)
    return sample, ctx, np.asarray(cond), np.asarray(mask)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_residuals_match_jax(models, flavour):
    jm, params, tm = models[flavour]
    cfg = jm.cfg
    assert cfg.set_noisy_sample_input_to_zero
    sample, ctx, cond, mask = _inputs(cfg, seed=1)
    want_down, want_mid = jm.apply(params, sample, jnp.array([400]), ctx, cond, mask, 0.7)
    with torch.no_grad():
        down, mid = tm(_t(sample), 400, _t(ctx), _t(cond), _t(mask), 0.7)
        other, _ = tm(_t(sample) * 3.0 + 1.0, 400, _t(ctx), _t(cond), _t(mask), 0.7)
        unit, unit_mid = tm(_t(sample), 400, _t(ctx), _t(cond), _t(mask), 1.0)
    # 1 conv_in + (layers_per_block + downsampler) per level, as the UNet's skips
    assert len(down) == len(want_down) == 8
    for i, (got, want) in enumerate(zip(down + (mid,), want_down + (want_mid,))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4,
                                   err_msg=f"residual {i}")
    assert float(mid.abs().max()) > 1e-3  # the random heads are not zero
    # set_noisy_sample_input_to_zero: the latents do not enter
    for a, b in zip(other, down):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # conv_in's bias broadcast is conv_in applied to zeros
    with torch.no_grad():
        zeros = spatial_conv(torch.zeros(B, F_, HW, HW, 4), tm.conv_in)
    torch.testing.assert_close(tm.conv_in.bias.expand_as(zeros), zeros, rtol=0, atol=0)
    # the scale multiplies every residual
    torch.testing.assert_close(unit_mid * 0.7, mid, rtol=1e-6, atol=0)
    for a, b in zip(unit, down):
        torch.testing.assert_close(a * 0.7, b, rtol=1e-6, atol=0)


def test_config_from_yaml_matches_jax():
    """The port's config from a sparsectrl YAML block equals JAX's, field
    for field, on the UNet's topology."""
    from motionclone_tpu_torch.config import load_yaml

    for name in ("latent_condition", "image_condition"):
        d = load_yaml(os.path.join(ROOT, "configs", "sparsectrl", f"{name}.yaml"))[
            "controlnet_additional_kwargs"]
        got = tsc.SparseControlNetConfig.from_yaml_dict(d, tcfg.tiny_unet_config())
        want = jsc.SparseControlNetConfig.from_yaml_dict(d, jcfg.tiny_unet_config())
        assert got == _port_cfg(want), name
        assert got.motion_module.attention_block_types == ("Temporal_Self",)
        assert got.motion_module.temporal_position_encoding_max_len == 32
        assert got.condition_downscale == (1 if name == "latent_condition" else 8)


def test_scatter_condition_matches_jax():
    r = np.random.default_rng(2)
    frames = r.standard_normal((2, 3, 5, 6, 4)).astype(np.float32)
    idx = (0, 2, 7)
    want_cond, want_mask = jsc.scatter_condition(jnp.asarray(frames), idx, 8)
    cond, mask = tsc.scatter_condition(_t(frames), idx, 8)
    np.testing.assert_array_equal(cond.numpy(), np.asarray(want_cond))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert mask.shape == (2, 8, 5, 6, 1)
    with pytest.raises(ValueError, match="image_index"):
        tsc.scatter_condition(_t(frames), (0, 1), 8)


# ---------------------------------------------------------------------------
# the UNet with residuals, and the conditioned slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet_pair():
    r = np.random.default_rng(50)
    x = r.standard_normal((B, F_, HW, HW, 4)).astype(np.float32)
    jm = JUNet(cfg=jcfg.tiny_unet_config(), guidance_blocks=GUIDANCE, attention_impl="xla")
    params = random_flax_params(jm, x, jnp.zeros((1,), jnp.int32),
                                np.zeros((1, 7, 16), np.float32), seed=51)
    return jm, params, load_port(TUNet(tcfg.tiny_unet_config()), params)


def test_unet_with_residuals_matches_jax(unet_pair, models):
    jm, params, tm = unet_pair
    r = np.random.default_rng(52)
    x = r.standard_normal((B, F_, HW, HW, 4)).astype(np.float32)
    ctx = r.standard_normal((B, 7, 16)).astype(np.float32)
    _, cn_params, cn = models["pixel"]
    sample, _, cond, mask = _inputs(cn.cfg, seed=53)
    with torch.no_grad():
        down, mid = cn(_t(sample), 300, _t(ctx), _t(cond), _t(mask))
    want, want_probs = jm.apply(params, x, jnp.array([300]), ctx,
                                down_block_residuals=tuple(d.numpy() for d in down),
                                mid_block_residual=mid.numpy())
    plain, _ = jm.apply(params, x, jnp.array([300]), ctx)
    with torch.no_grad():
        got, probs = tm(_t(x), 300, _t(ctx), guidance_blocks=GUIDANCE,
                        down_block_residuals=down, mid_block_residual=mid)
    close(got, want)
    assert sorted(probs) == sorted(want_probs)
    for k in probs:
        close(probs[k], want_probs[k], label=k)
    # the residuals move the prediction
    assert np.abs(np.asarray(want) - np.asarray(plain)).max() > 1e-2
    with pytest.raises(ValueError, match="residuals"):
        tm(_t(x), 300, _t(ctx), down_block_residuals=down[:-1])


def _infer(mod):
    return mod.InferenceConfig(
        inference_steps=4, guidance_steps=2, guidance_fraction=0.3,
        warm_up_steps=1, cool_up_steps=1, motion_guidance_weight=50.0,
        motion_guidance_blocks=GUIDANCE, add_noise_step=400,
        cfg_scale=7.5, width=HW * 8, height=HW * 8, video_length=F_,
    )


def test_conditioned_extraction_and_sampling_match_jax(unet_pair):
    jm, params, tm = unet_pair
    # the RGB flavour with the latents read (set_noisy_sample_input_to_zero
    # off): a gradient through the controlnet would change the guided steps
    cn_cfg = dataclasses.replace(tiny_cn_config(simplified=True),
                                 set_noisy_sample_input_to_zero=False)
    jcn, cn_params, tcn = _build(cn_cfg, seed=60)
    r = np.random.default_rng(61)
    shape = (B, F_, HW, HW, 4)
    video_latents, extract_noise, init = (r.standard_normal(shape).astype(np.float32)
                                          for _ in range(3))
    uncond, cond = (r.standard_normal((B, 7, 16)).astype(np.float32) for _ in range(2))
    frames = r.standard_normal((B, 1, HW, HW, 4)).astype(np.float32)
    j_cond, j_mask = jsc.scatter_condition(jnp.asarray(frames), (0,), F_)
    t_cond, t_mask = tsc.scatter_condition(_t(frames), (0,), F_)

    fns_j = j_make_fns(jcfg.tiny_unet_config(), jcfg.NoiseScheduleConfig(), _infer(jcfg),
                       dtype=jnp.float32, attention_impl="xla",
                       controlnet_apply=make_controlnet_apply(jcn))
    fns_t = t_make_fns(tm, tcfg.NoiseScheduleConfig(), _infer(tcfg), controlnet=tcn)
    j_cn = (j_cond, j_mask, 0.8)
    t_cn = (t_cond, t_mask, 0.8)
    rep_j = fns_j.extract(params, video_latents, extract_noise, uncond, cn_params, j_cn)
    rep_t = fns_t.extract(_t(video_latents), _t(extract_noise), _t(uncond), t_cn)
    assert sorted(rep_t) == sorted(rep_j) and len(rep_t) == 4
    for k in rep_t:
        np.testing.assert_allclose(rep_t[k][0].numpy(), np.asarray(rep_j[k][0]),
                                   atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_array_equal(rep_t[k][1].numpy(), np.asarray(rep_j[k][1]),
                                      err_msg=k)
    # the condition moved the representation
    plain = fns_t.extract(_t(video_latents), _t(extract_noise), _t(uncond))
    assert any(not torch.equal(plain[k][0], rep_t[k][0]) for k in rep_t)

    want = fns_j.sample(params, init, uncond, cond, rep_j, cn_params, j_cn)
    got = fns_t.sample(_t(init), _t(uncond), _t(cond), rep_t, cn_cond=t_cn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)
    unconditioned = fns_t.sample(_t(init), _t(uncond), _t(cond), rep_t)
    assert (got - unconditioned).abs().max() > 1e-2


def test_controlnet_residuals_carry_no_gradient(unet_pair, models, monkeypatch):
    """The guided step computes the residuals without grad, once on the CFG
    pair, and hands each pass its half."""
    _, _, tm = unet_pair
    _, _, cn = models["latent"]
    seen = []
    forward = cn.forward

    def spy(*args, **kwargs):
        out = forward(*args, **kwargs)
        seen.append((args[0].shape[0], torch.is_grad_enabled(), out))
        return out

    monkeypatch.setattr(cn, "forward", spy)
    halves = []
    unet_forward = tm.forward

    def unet_spy(*args, **kwargs):
        halves.append(kwargs.get("down_block_residuals"))
        return unet_forward(*args, **kwargs)

    monkeypatch.setattr(tm, "forward", unet_spy)
    fns = t_make_fns(tm, tcfg.NoiseScheduleConfig(), _infer(tcfg), controlnet=cn)
    r = np.random.default_rng(70)
    lat = _t(r.standard_normal((B, F_, HW, HW, 4)).astype(np.float32))
    emb = _t(r.standard_normal((B, 7, 16)).astype(np.float32))
    cond, _, c, m = _inputs(cn.cfg, seed=71)
    rep = fns.extract(lat, lat, emb)
    fns.guided_step(lat, 801, 781, 1.0, emb, emb, rep, (_t(c[:, :]), _t(m), 1.0))
    (b, grad_on, (down, mid)), = seen
    assert b == 2 * B and not grad_on
    assert not mid.requires_grad and not any(d.requires_grad for d in down)
    uncond_half, cond_half = halves[-2:]
    for d, u, c_ in zip(down, uncond_half, cond_half):
        torch.testing.assert_close(u, d[:B], rtol=0, atol=0)
        torch.testing.assert_close(c_, d[B:], rtol=0, atol=0)


def test_controlnet_under_a_frame_group_raises(unet_pair, models):
    """A frame-sharded controlnet needs cn_cond on every call (the JAX
    package's ``_check_smap_cn_cond``), and the full condition to split;
    both refusals come before any collective."""
    group = FrameGroup(rank=0, size=2, backend="gloo")
    fns = t_make_fns(unet_pair[2], tcfg.NoiseScheduleConfig(), _infer(tcfg),
                     frame_group=group, controlnet=models["latent"][2])
    lat = torch.zeros(B, F_, HW, HW, 4)
    emb = torch.zeros(B, 7, 16)
    rep = {"m": (torch.zeros(1, 1, 1, F_ // 2, 1), torch.zeros(1, 1, 1, F_ // 2, 1))}
    with pytest.raises(ValueError, match="need cn_cond on every call"):
        fns.extract(lat, lat, emb)
    with pytest.raises(ValueError, match="need cn_cond on every call"):
        fns.sample(lat[:, :F_ // 2], emb, emb, rep)
    with pytest.raises(ValueError, match="need cn_cond on every call"):
        fns.guided_step(lat[:, :F_ // 2], 801, 781, 1.0, emb, emb, rep)
    with pytest.raises(ValueError, match="need cn_cond on every call"):
        fns.vanilla_step(lat[:, :F_ // 2], 801, 781, emb, emb)
    for plain in (fns.sample_plain, fns.sample_plain_probs):
        with pytest.raises(ValueError, match="need cn_cond on every call"):
            plain(lat[:, :F_ // 2], emb, emb)
    half = torch.zeros(B, F_ // 2, HW, HW, 4)
    with pytest.raises(ValueError, match="full 4 frames of the condition"):
        fns.vanilla_step(half, 801, 781, emb, emb, (half, half[..., :1], 1.0))


def test_chip_smoke_predicts_the_controlnet_route_at_sd15_width():
    """chip_smoke.py's PREDICTED_CONTROLNET_LAUNCHES (one controlnet pass at
    512x512x16f, SD1.5 width) equals what the modules' routing predicates
    give on CUDA, from the shapes alone (the model lives on the meta
    device): fused resnets, spatial transformers and motion modules, one
    flash launch per unfused transformer's self-attention, one temporal
    launch per unfused motion module's attention block."""
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke

    cfg = tsc.SparseControlNetConfig.from_yaml_dict(
        tcfg.load_yaml(os.path.join(ROOT, "configs", "sparsectrl", "image_condition.yaml"))[
            "controlnet_additional_kwargs"], tcfg.UNet3DConfig())
    with torch.device("meta"):
        cn = tsc.SparseControlNetModel(cfg)
    for b in (1, 2):
        counts = dict.fromkeys(chip_smoke.PREDICTED_CONTROLNET_LAUNCHES, 0)
        ch, side = cfg.block_out_channels[0], 64
        blocks = list(cn.down_blocks) + [cn.mid_block]
        for i, block in enumerate(blocks):
            for j, resnet in enumerate(block.resnets):
                counts["fused_resnet_block"] += resnet.fused_route((b, 16, side, side, ch),
                                                                  "cuda")
                ch = resnet.conv1.out_channels
                x_shape = (b, 16, side, side, ch)
                attn = getattr(block, "attentions", None)
                if attn is not None and j < len(attn):
                    route = attn[j].fused_route(x_shape, (b, 77, 768), "cuda")
                    key = "fused_spatial_transformer" if route else "flash_fwd"
                    counts[key] += 1
                if block.motion_modules is not None and j < len(block.motion_modules):
                    tt = block.motion_modules[j].temporal_transformer
                    if tt.fused_route(x_shape, "cuda"):
                        counts["fused_temporal_module"] += 1
                    else:
                        counts["temporal_fwd"] += len(tt.transformer_blocks[0].attention_blocks)
            if i < len(cn.down_blocks) and block.downsamplers is not None:
                side //= 2
        assert counts == chip_smoke.PREDICTED_CONTROLNET_LAUNCHES, (b, counts)
    for name, per in chip_smoke.PREDICTED_I2V_LAUNCHES.items():
        extra = chip_smoke.PREDICTED_CONTROLNET_LAUNCHES.get(name, 0)
        assert per == tuple(n + extra for n in chip_smoke.PREDICTED_LAUNCHES[name])
