"""SDXL base 1.0 with AnimateDiff-SDXL's motion modules on the port, at a
tiny SDXL-shaped size on the CPU (3 levels, transformer depths [0, 1, 2],
8-wide heads, linear projections, the text_time embedding, two tiny text
towers), against the benchmark's plain reference
(``bench_h100/reference/sdxl_nets.py``, which imports nothing of the port)
on the same seeded weights (``bench_h100/weights.py``, f32): the UNet's
output and its guidance block's probabilities, the guidance gradient to
the latents with recompute on and off, both towers' penultimate states and
the pooled projection, and the runtime on a tiny synthetic diffusers
directory.

Both sides compute in f32 on the CPU, in different orders (the port's
GroupNorm takes E[x^2] - mean^2, the reference ``var``; the port's
attention is its kernels' plain version, the reference's blocked
softmax), so they agree to f32 rounding carried through the depth: a
relative L2 gap of ``RTOL`` bounds it with room (read: ~1e-7 to 1e-6).
Recompute runs the same operations again in the backward, so the
gradient with and without it agrees to the bit on the CPU; ``RTOL`` is
kept as its bound all the same.
"""

import json
import os

import numpy as np
import pytest
import torch

from bench_h100 import weights
from bench_h100.reference import sdxl_nets
from motionclone_tpu_torch.config import (InferenceConfig, MotionModuleConfig,
                                          NoiseScheduleConfig, UNet3DConfig)
from motionclone_tpu_torch.diffusion.guidance import motion_guidance_loss, sparsify_top1
from motionclone_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from motionclone_tpu_torch.models.layers import recomputed_segments
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
from motionclone_tpu_torch.pipeline.motionclone import Conditioning, make_sampling_fns
from motionclone_tpu_torch.utils import trace
from test_torch_models import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 2020
RTOL = 1e-4  # f32 against f32 in another order (module docstring)
GUIDANCE = ("up_blocks.0",)
F, SIDE = 4, 16  # frames, latent side


def tiny_config() -> dict:
    """The benchmark's SDXL configuration at tiny widths (depths [0, 1, 2],
    8-wide heads) and the same keys."""
    with open(os.path.join(ROOT, "bench_h100", "configs", "sdxl-adxl-t2v.json")) as fh:
        c = json.load(fh)
    c["unet"].update(block_out_channels=[16, 16, 32], norm_num_groups=4, cross_attention_dim=32,
                     attention_head_dim=[2, 2, 4], transformer_layers_per_block=[0, 1, 2],
                     addition_time_embed_dim=8, projection_class_embeddings_input_dim=64)
    c["unet"]["motion_module"].update(num_attention_heads=2, norm_num_groups=4)
    c["vae"].update(block_out_channels=[8, 8, 16, 16], layers_per_block=1, norm_num_groups=4)
    for key, proj in (("text_encoder", None), ("text_encoder_2", 16)):
        c[key].update(vocab_size=520, hidden_size=16, num_layers=2, num_heads=2,
                      intermediate_size=32, projection_dim=proj)
    return c


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def unet_config(c, recompute=None) -> UNet3DConfig:
    u = dict(_tuples(c["unet"]), motion_module=MotionModuleConfig(
        **_tuples(c["unet"]["motion_module"])))
    if recompute is not None:
        u["guided_recompute"] = recompute
    return UNet3DConfig(**u)


@pytest.fixture(scope="module")
def models():
    """(config, reference networks, their f32 seeded weights)."""
    c = tiny_config()
    ref = sdxl_nets.build(c, "cpu")
    tensors = weights.make(ref, SEED, "cpu", dtype=torch.float32)
    for key, m in ref.items():
        weights.load(m, tensors[key])
    return c, ref, tensors


def port(cls, cfg, tensors):
    m = cls(cfg).float().eval()
    weights.load(m, tensors)
    return m.requires_grad_(False)


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def inputs(c, batch=1):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(batch, F, SIDE, SIDE, 4, generator=g)
    ctx = torch.randn(batch, 7, c["unet"]["cross_attention_dim"], generator=g)
    pooled = torch.randn(batch, 16, generator=g)
    ids = torch.tensor([[128.0, 128.0, 0.0, 0.0, 128.0, 128.0]]).repeat(batch, 1)
    return x, ctx, pooled, ids


def test_unet_and_guidance_probs_match_the_plain_reference(models):
    c, ref, tensors = models
    unet = port(UNet3DConditionModel, unet_config(c), tensors["unet"])
    x, ctx, pooled, ids = inputs(c, batch=2)
    got, probs = unet(x, 500, ctx, guidance_blocks=GUIDANCE, added_cond=(pooled, ids))
    want, ref_probs = ref["unet"](x, 500, (ctx, pooled, ids), GUIDANCE)
    assert rel(got, want) < RTOL
    assert sorted(probs) == sorted(ref_probs) and len(probs) == 6  # 3 modules x 2 attentions
    for k in probs:
        assert rel(probs[k], ref_probs[k]) < RTOL
    # the added embedding moves the output: it is not ignored
    other, _ = unet(x, 500, ctx, added_cond=(pooled, ids * 0.5))
    assert rel(other, got) > 1e-3
    with pytest.raises(ValueError, match="added_cond"):
        unet(x, 500, ctx)


def test_guidance_gradient_with_and_without_recompute(models):
    """The guided step's differentiated pass (its conditional forward to
    the cut and the loss's backward to the latents): recompute on gives
    the gradient of recompute off, and both the reference's."""
    c, ref, tensors = models
    x, ctx, pooled, ids = inputs(c)
    _, probs = ref["unet"](torch.roll(x, 1, dims=1), 400, (ctx, pooled, ids), GUIDANCE,
                           max_up_block=0)
    rep = {k: sparsify_top1(p) for k, p in probs.items()}

    def grad(unet):
        leaf = x.clone().requires_grad_(True)
        with torch.enable_grad():
            _, p = unet(leaf, 500, ctx, guidance_blocks=GUIDANCE, post_guidance_cut=0,
                        added_cond=(pooled, ids))
            return torch.autograd.grad(2000.0 * motion_guidance_loss(p, rep, None), leaf)[0]

    plain = grad(port(UNet3DConditionModel, unet_config(c, False), tensors["unet"]))
    before = recomputed_segments()
    again = grad(port(UNet3DConditionModel, unet_config(c, True), tensors["unet"]))
    # the transformer layers up to the cut: 2 in down_blocks.1, 4 in
    # down_blocks.2, 2 in the mid block and 6 in up_blocks.0
    assert recomputed_segments() - before == 2 + 4 + 2 + 6
    assert plain.norm() > 0
    assert rel(again, plain) < RTOL
    leaf = x.clone().requires_grad_(True)
    ref["unet"].set_recompute(True)
    try:
        with torch.enable_grad():
            _, p = ref["unet"](leaf, 500, (ctx, pooled, ids), GUIDANCE, grad_cut=0)
            want = torch.autograd.grad(2000.0 * motion_guidance_loss(p, rep, None), leaf)[0]
    finally:
        ref["unet"].set_recompute(False)
    assert rel(plain, want) < RTOL


def test_text_towers_penultimate_state_and_pooled_projection(models):
    c, ref, tensors = models
    ids = torch.full((3, 77), 0, dtype=torch.long)
    ids[:, 0], ids[:, 1:6], ids[:, 6] = 518, torch.arange(5, 20, 3), 519
    ids_l = torch.where(ids == 0, torch.full_like(ids, 519), ids)  # CLIP-L pads with EOS
    one = port(CLIPTextModel, CLIPTextConfig(**c["text_encoder"]), tensors["text_encoder"])
    two = port(CLIPTextModel, CLIPTextConfig(**c["text_encoder_2"]), tensors["text_encoder_2"])
    state_1, none = one.encode(ids_l)
    state_2, pooled = two.encode(ids)
    want_1, _ = ref["text_encoder"](ids_l)
    want_2, want_pooled = ref["text_encoder_2"](ids)
    assert none is None and pooled.shape == (3, 16)
    assert rel(state_1, want_1) < RTOL and rel(state_2, want_2) < RTOL
    assert rel(pooled, want_pooled) < RTOL
    # penultimate: not the final-LayerNorm state SD1.5 takes
    last = dict(c["text_encoder"], output_hidden_state="last")
    assert rel(port(CLIPTextModel, CLIPTextConfig(**last), tensors["text_encoder"])(ids_l),
               state_1) > 1e-2


def test_sdxl_refuses_frame_sharding_and_the_cfg_pair_and_carries_the_approx_caches(models):
    c, _, tensors = models
    unet = port(UNet3DConditionModel, unet_config(c), tensors["unet"])
    infer = InferenceConfig(inference_steps=4, guidance_steps=2, warm_up_steps=1,
                            cool_up_steps=1, motion_guidance_blocks=GUIDANCE, width=8 * SIDE,
                            height=8 * SIDE, video_length=F)
    sched = NoiseScheduleConfig(**c["noise_schedule"])

    class Group:
        size, rank = 2, 0

    for kw in (dict(frame_group=Group()), dict(cfg_pair=Group())):
        with pytest.raises(ValueError, match="text_time"):
            make_sampling_fns(unet, sched, infer, **kw)
    x, ctx, pooled, ids = inputs(c)
    cond = Conditioning(ctx, pooled, ids)
    fns = make_sampling_fns(unet, sched, infer, uncond_interval=2)
    rep = fns.extract(x, torch.randn_like(x), cond)
    out = fns.sample(x, cond, cond, rep)
    assert out.shape == x.shape and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the runtime on a tiny synthetic diffusers directory
# ---------------------------------------------------------------------------


def _write_tokenizer(path, pad):
    from motionclone_tpu_torch.io.tokenizer import bytes_to_unicode

    os.makedirs(path)
    chars = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(chars + [ch + "</w>" for ch in chars]
                                        + ["<|startoftext|>", "<|endoftext|>"])}
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump(vocab, fh, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n")
    with open(os.path.join(path, "special_tokens_map.json"), "w") as fh:
        json.dump({"pad_token": pad}, fh)


def _write_module(root, sub, sd, config):
    from motionclone_tpu_torch.weights.io import save_safetensors

    os.makedirs(os.path.join(root, sub))
    save_safetensors(os.path.join(root, sub, "diffusion_pytorch_model.safetensors"), sd)
    with open(os.path.join(root, sub, "config.json"), "w") as fh:
        json.dump(config, fh)


def test_runtime_builds_sdxl_from_a_diffusers_directory(models, tmp_path):
    from motionclone_tpu_torch.pipeline.runner import MotionCloneRuntime

    c, _, tensors = models
    u, root = c["unet"], str(tmp_path / "sdxl")
    unet_sd = {k: v.contiguous() for k, v in tensors["unet"].items()}
    _write_module(root, "unet", {k: v for k, v in unet_sd.items() if "motion_modules." not in k},
                  dict({k: u[k] for k in (
                      "in_channels", "out_channels", "block_out_channels", "layers_per_block",
                      "norm_num_groups", "cross_attention_dim", "attention_head_dim",
                      "transformer_layers_per_block", "addition_embed_type",
                      "addition_time_embed_dim", "projection_class_embeddings_input_dim",
                      "use_linear_projection", "flip_sin_to_cos", "freq_shift")},
                       down_block_types=["DownBlock2D", "CrossAttnDownBlock2D",
                                         "CrossAttnDownBlock2D"],
                       up_block_types=["CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                                       "UpBlock2D"]))
    _write_module(root, "vae", tensors["vae"], {k: c["vae"][k] for k in c["vae"]})
    for key in ("text_encoder", "text_encoder_2"):
        t = c[key]
        _write_module(root, key, tensors[key], dict(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
            num_hidden_layers=t["num_layers"], num_attention_heads=t["num_heads"],
            intermediate_size=t["intermediate_size"], hidden_act=t["hidden_act"],
            max_position_embeddings=77, projection_dim=t["projection_dim"]))
    _write_tokenizer(os.path.join(root, "tokenizer"), "<|endoftext|>")
    _write_tokenizer(os.path.join(root, "tokenizer_2"), "!")
    torch.save({"state_dict": {k: v for k, v in unet_sd.items() if "motion_modules." in k}},
               str(tmp_path / "mm_sdxl.ckpt"))
    mm = u["motion_module"]
    (tmp_path / "model.yaml").write_text(
        "unet_additional_kwargs:\n  use_inflated_groupnorm: true\n  use_motion_module: true\n"
        "  motion_module_resolutions: [1, 2, 4, 8]\n  motion_module_mid_block: false\n"
        "  guided_recompute: true\n  motion_module_kwargs:\n"
        f"    num_attention_heads: {mm['num_attention_heads']}\n    num_transformer_block: 1\n"
        "    attention_block_types: [Temporal_Self, Temporal_Self]\n"
        "    temporal_position_encoding: true\n    temporal_position_encoding_max_len: 32\n"
        f"    norm_num_groups: {mm['norm_num_groups']}\n"
        "noise_scheduler_kwargs:\n  beta_schedule: scaled_linear\n  steps_offset: 1\n"
        "  set_alpha_to_one: false\n")
    infer = InferenceConfig(motion_module="mm_sdxl.ckpt", model_config="model.yaml",
                            inference_steps=4, guidance_steps=2, warm_up_steps=1,
                            cool_up_steps=1, motion_guidance_blocks=GUIDANCE,
                            width=8 * SIDE, height=8 * SIDE, video_length=F)
    rt = MotionCloneRuntime(root, infer, device="cpu", dtype=torch.float32,
                            config_root=str(tmp_path))
    cfg = rt.unet_cfg
    assert (cfg.block_out_channels, cfg.attention_head_dim, cfg.transformer_layers_per_block,
            cfg.addition_embed_type, cfg.guided_recompute) == (
        (16, 16, 32), (2, 2, 4), (0, 1, 2), "text_time", True)
    assert rt.tokenizer_2.pad_token_id == 0 and rt.tokenizer.pad_token_id == 513
    assert rt.clip_cfg.output_hidden_state == rt.clip2_cfg.output_hidden_state == "penultimate"
    uncond, cond = rt.encode_prompt(["a cat", "a dog"], "", num_videos_per_prompt=2)
    assert isinstance(cond, Conditioning) and cond.context.shape == (4, 77, 32)
    assert cond.pooled.shape == (4, 16)
    assert cond.time_ids.tolist() == [[128, 128, 0, 0, 128, 128]] * 4
    assert torch.equal(cond.context[0], cond.context[1])
    # the weights reached the modules: the runtime's towers agree with the
    # tensors written, the motion modules with the .ckpt's
    assert torch.equal(rt.pipeline.unet.state_dict()[
        "up_blocks.0.motion_modules.0.temporal_transformer.proj_in.weight"],
        unet_sd["up_blocks.0.motion_modules.0.temporal_transformer.proj_in.weight"])
    ids = torch.from_numpy(np.concatenate(
        [rt.tokenizer_2.encode_padded("a cat")] * 2).astype(np.int64))
    # bigG's ids pad with 0, so the largest id of a row is its EOS (the pooled position)
    assert ids[0, -1] == 0 and ids[0, ids.argmax(-1)[0]] == rt.tokenizer_2.eos_token_id
    # one guided and one vanilla step through the pipeline's sampling, with
    # the step record's count of recomputed segments
    x, _, _, _ = inputs(c)
    pipe = rt.pipeline
    rep = pipe.extract_motion_representation(x, uncond.rows(slice(0, 1)), seed=3)
    one = lambda e: e.rows(slice(0, 1))
    out = pipe.sample_latents(one(uncond), one(cond), rep, seed=3)
    assert out.shape == (1, F, SIDE, SIDE, 4) and torch.isfinite(out).all()
    steps = trace.last_run().steps
    assert [s.attrs.get("recomputed") for s in steps] == [2 + 4 + 2 + 6] * 2 + [None] * 2
