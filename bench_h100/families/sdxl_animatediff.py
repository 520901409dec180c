"""The SDXL family: SDXL base 1.0's UNet with AnimateDiff-SDXL's motion
modules, the SD VAE, and two text towers, CLIP ViT-L/14 and OpenCLIP
ViT-bigG/14 (``families/__init__.py`` lists what a family gives).

Its plain reference is ``reference/sdxl_nets.py`` and
``reference/sdxl_job.py``; its FLOPs are counted here, over that reference
on the meta device, with no recompute (so the program's recompute shows as
a lower ``mfu``); its kernels are ``work/bounds.KERNELS``, the common table
(kernels 1 and 2 at head dim 64 do all of its spatial attention), so it
adds none.  A job runs a batch as the SD1.5 family's does, its text the
program's ``Conditioning`` of 2B+1 rows (the prompts, the negative prompt
once an example, the empty prompt): both towers' penultimate states joined,
bigG's pooled text, and the size and crop ids of the traffic's video.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100 import check, harness, weights
from bench_h100.reference import diffusion, sdxl_job, sdxl_nets
from bench_h100.trace import Tracer


class Conditioning:
    """A job's text conditioning: the program's ``Conditioning`` of 2B+1
    rows, the B prompts, the negative prompt once an example, then the
    empty prompt."""

    def __init__(self, rows, batch: int):
        self.rows, self.batch = rows, batch

    def prompts(self):
        return self.rows.rows(slice(0, self.batch))

    def negatives(self):
        return self.rows.rows(slice(self.batch, 2 * self.batch))

    def empty(self):
        return self.rows.rows(slice(2 * self.batch, None))

    def example(self, e: int):
        """(negative, prompt) of example ``e``, each (context, pooled, time
        ids) of one row."""
        b = self.batch
        return tuple((c.context, c.pooled, c.time_ids) for c in (
            self.rows.rows(slice(b + e, b + e + 1)), self.rows.rows(slice(e, e + 1))))


def networks(config: Mapping, device="meta") -> Dict[str, torch.nn.Module]:
    return sdxl_nets.build(config, device)


def _tuples(d: Mapping) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_program(config: Mapping, traffic: Mapping, tensors: Mapping, device,
                  lap: Callable[[str], None] = lambda stage: None):
    from motionclone_tpu_torch.config import (InferenceConfig, MotionModuleConfig,
                                              NoiseScheduleConfig, UNet3DConfig)
    from motionclone_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    lap("program_imports")
    dtype = getattr(torch, config["dtype"])

    def make(cls, cfg, key):
        with torch.device("meta"), sdxl_nets.initialisers_off():
            m = cls(cfg)
        m = m.to(dtype).to_empty(device=device)
        weights.load(m, tensors[key])
        return m

    unet_cfg = UNet3DConfig(**dict(_tuples(config["unet"]),
                                   motion_module=MotionModuleConfig(
                                       **_tuples(config["unet"]["motion_module"]))))
    s, v = traffic["schedule"], traffic["video"]
    infer = InferenceConfig(
        cfg_scale=s["cfg_scale"], inference_steps=s["inference_steps"],
        guidance_fraction=s["guidance_fraction"], guidance_steps=s["guidance_steps"],
        warm_up_steps=s["warm_up_steps"], cool_up_steps=s["cool_up_steps"],
        motion_guidance_weight=s["motion_guidance_weight"],
        motion_guidance_blocks=tuple(s["motion_guidance_blocks"]),
        add_noise_step=s["add_noise_step"], width=v["width"], height=v["height"],
        video_length=v["frames"])
    unet = make(UNet3DConditionModel, unet_cfg, "unet")
    vae = make(AutoencoderKL, VAEConfig(**_tuples(config["vae"])), "vae")
    text = make(CLIPTextModel, CLIPTextConfig(**config["text_encoder"]), "text_encoder")
    text_2 = make(CLIPTextModel, CLIPTextConfig(**config["text_encoder_2"]), "text_encoder_2")
    lap("program_modules")
    return MotionClonePipeline(
        unet_cfg, NoiseScheduleConfig(**config["noise_schedule"]), infer, unet, vae=vae,
        text_encoder=text, text_encoder_2=text_2, device=device, dtype=dtype,
        attention_impl=config["attention_impl"])


def denoiser(pipe):
    return pipe.unet


def words(config: Mapping) -> int:
    """The ids below BOS and EOS, the vocabulary's last two (both towers
    share CLIP's 49408)."""
    return config["text_encoder"]["vocab_size"] - 2


def token_ids(config: Mapping, prompts: Sequence[np.ndarray], device):
    """(CLIP-L's ids, bigG's ids), each (rows, 77) int64: BOS, the prompt's
    ids, EOS, then CLIP-L's padding with EOS and bigG's with id 0, as SDXL's
    two tokenizers frame a prompt."""
    out = []
    for key, pad in (("text_encoder", None), ("text_encoder_2", 0)):
        c = config[key]
        bos, eos = c["vocab_size"] - 2, c["vocab_size"] - 1
        rows = np.full((len(prompts), c["max_position_embeddings"]),
                       eos if pad is None else pad, dtype=np.int64)
        rows[:, 0] = bos
        for row, ids in zip(rows, prompts):
            row[1:len(ids) + 1] = ids
            row[len(ids) + 1] = eos
        out.append(torch.from_numpy(rows).to(device))
    return tuple(out)


def run_job(pipe, inp, traffic: Mapping, tracer, recorder=None) -> Dict[str, object]:
    b = traffic["batch"]
    g = traffic["schedule"]["guidance_steps"]
    with tracer.span("text"):
        text = Conditioning(pipe.encode_text(inp.ids), b)
    with tracer.span("encode"):
        latents = pipe.encode_video(inp.clips, inp.seeds)
    with tracer.span("extract"):
        rep = pipe.extract_motion_representation(latents, text.empty().repeat(b),
                                                 seed=inp.seeds)
    marks = [("start", harness.mark(pipe.device))]

    def on_step(i, guided):
        marks.append(("guided" if guided else "vanilla", harness.mark(pipe.device)))
        tracer.switch(None if i + 1 >= len(pipe.fns.timesteps)
                      else "guided_step" if i + 1 < g else "vanilla_step")

    if recorder is not None:
        recorder.arm()
    tracer.switch("guided_step" if g > 0 else "vanilla_step")
    final = pipe.sample_latents(text.negatives(), text.prompts(), rep, seed=inp.seeds,
                                on_step=on_step)
    tracer.switch(None)
    if recorder is not None:
        recorder.disarm()
    videos = []
    with tracer.span("decode"):
        for e in range(b):
            video = pipe.decode_latents(final[e:e + 1])
            video01 = (video.float() / 2 + 0.5).clamp(0.0, 1.0)
            videos.append(torch.round(video01 * 255.0).to(torch.uint8).cpu())
    return dict(text=text.rows.context, pooled=text.rows.pooled, conditioning=text,
                latents=latents, condition=None, rep=rep, final=final,
                frames=torch.stack(videos), marks=marks,
                states=dict(recorder.states) if recorder is not None else {},
                grads=dict(recorder.grads) if recorder is not None else {})


def warm_up(pipe, inp, traffic: Mapping) -> None:
    """A job's stages with one guided and one vanilla step in place of the
    schedule."""
    fns = pipe.fns
    t, tp = (int(x) for x in fns.timesteps[:2])
    g = traffic["schedule"]["guidance_steps"]
    tv, tpv = int(fns.timesteps[g]), int(fns.timesteps[g + 1])

    class Short:  # the job's stages, sampling replaced by one step of each kind
        def __getattr__(self, name):
            return getattr(pipe, name)

        def sample_latents(self, uncond, cond, rep, seed, on_step=None):
            lat = pipe.initial_latents(seed)
            uncond, cond = uncond.to(pipe.dtype), cond.to(pipe.dtype)
            lat, _ = fns.guided_step(lat, t, tp, 1.0, uncond, cond, rep)
            return fns.vanilla_step(lat, tv, tpv, uncond, cond)

    run_job(Short(), inp, traffic, Tracer(False))
    harness.sync(pipe.device)


def reference(nets: Mapping, config: Mapping, traffic: Mapping, device, inp,
              program: Mapping, steps: Sequence[int],
              store: Callable[[torch.Tensor], torch.Tensor] = lambda x: x) -> Dict[str, object]:
    return sdxl_job.Reference(nets, config, traffic, device, store=store).run(
        inp.ids, inp.clips, inp.seeds, program, steps)


def readings(got: Mapping, ref: Mapping) -> Dict[str, float]:
    """``pooled``: the relative L2 gap of bigG's pooled text (2B+1 rows)."""
    return {"pooled": check.rel_l2(got["pooled"], ref["pooled"])}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def job_flops(config: Mapping, traffic: Mapping) -> Dict[str, float]:
    """``work/flops.job_flops``'s components for SDXL, over the reference
    networks on the meta device without recompute: both towers on 2B+1
    rows, the VAE encode, the extraction, a guided step (the unconditional
    forward, the conditional forward and its backward to the latents
    through the guidance cut), a vanilla step (the CFG pair) and the
    decode."""
    m = networks(config)
    unet, vae = m["unet"], m["vae"]
    b, video, sched = traffic["batch"], traffic["video"], traffic["schedule"]
    f, hh, ww = video["frames"], video["height"], video["width"]
    lat = (b, f, hh // 8, ww // 8, config["unet"]["in_channels"])
    meta = dict(device="meta")
    t = config["text_encoder"]["max_position_embeddings"]

    def cond(rows):
        return (torch.empty(rows, t, config["unet"]["cross_attention_dim"], **meta),
                torch.empty(rows, config["text_encoder_2"]["projection_dim"], **meta),
                torch.empty(rows, 6, **meta))

    guidance = tuple(sched["motion_guidance_blocks"])
    cut = int(guidance[-1].rsplit(".", 1)[-1])
    ids = torch.zeros(2 * b + 1, t, dtype=torch.long, **meta)
    counts: Dict[str, float] = {}
    counts["text"] = _count(lambda: sdxl_nets.encode_text(m, (ids, ids)))
    counts["vae_encode"] = _count(lambda: vae.encode(torch.empty(b * f, hh, ww, 3, **meta)))
    rep = {}

    def extract():
        _, probs = unet(torch.empty(lat, **meta), 1, cond(b), guidance, max_up_block=cut)
        rep.update({k: diffusion.top1(p) for k, p in probs.items()})

    counts["extract"] = _count(extract)

    def guided():
        with torch.no_grad():
            unet(torch.empty(lat, **meta), 1, cond(b))
        leaf = torch.empty(lat, **meta, requires_grad=True)
        with torch.enable_grad():
            # a non-leaf input: the counter's module hooks refuse a leaf under autograd.grad
            _, probs = unet(leaf * 1.0, 1, cond(b), guidance, grad_cut=cut)
            torch.autograd.grad(diffusion.guidance_loss(probs, rep), leaf)

    def vanilla():
        with torch.no_grad():
            unet(torch.empty(2 * b, *lat[1:], **meta), 1, cond(2 * b))

    counts["guided_step"] = _count(guided)
    counts["vanilla_step"] = _count(vanilla)
    counts["vae_decode"] = _count(lambda: vae.decode(torch.empty(b * f, *lat[2:], **meta)))
    g = sched["guidance_steps"]
    v = sched["inference_steps"] - g
    counts["job"] = (sum(c for k, c in counts.items() if not k.endswith("_step"))
                     + g * counts["guided_step"] + v * counts["vanilla_step"])
    return counts


def kernels() -> Dict:
    return {}
