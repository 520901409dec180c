"""The SD1.5 family: SD1.5's UNet3D with AnimateDiff's motion modules, the
SparseCtrl controlnet where the configuration has one, the SD VAE and
CLIP ViT-L/14's text tower (``families/__init__.py`` lists what a family
gives).

Its plain reference is ``reference/nets.py`` and ``reference/job.py``, its
FLOPs ``work/flops.py``; its kernels are ``work/bounds.KERNELS``, the
common table, so it adds none.  A job runs the sweep's batch in its order
(``pipeline/sweep.py``'s ``_run_batch``): CLIP on 2B+1 rows, the VAE
encode, the i2v conditions, extraction, guided sampling at the full
schedule, and each example's decode to uint8 copied to the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from bench_h100 import harness, weights
from bench_h100.reference import job as ref_job
from bench_h100.reference import nets as ref_nets
from bench_h100.trace import Tracer
from bench_h100.work import flops


class Conditioning:
    """A job's text conditioning: CLIP's rows (2B+1, T, D), the B prompts,
    the negative prompt once an example, then the empty prompt."""

    def __init__(self, rows: torch.Tensor, batch: int):
        self.rows, self.batch = rows, batch

    def prompts(self) -> torch.Tensor:
        return self.rows[:self.batch]

    def negatives(self) -> torch.Tensor:
        return self.rows[self.batch:2 * self.batch]

    def empty(self) -> torch.Tensor:
        return self.rows[2 * self.batch:]

    def example(self, e: int):
        """(negative, prompt) of example ``e``, each (1, T, D)."""
        b = self.batch
        return self.rows[b + e:b + e + 1], self.rows[e:e + 1]


def networks(config: Mapping, device="meta") -> Dict[str, torch.nn.Module]:
    return ref_nets.build(config, device)


def _tuples(d: Mapping) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_program(config: Mapping, traffic: Mapping, tensors: Mapping, device,
                  lap: Callable[[str], None] = lambda stage: None):
    from motionclone_tpu_torch.config import (InferenceConfig, MotionModuleConfig,
                                              NoiseScheduleConfig, UNet3DConfig)
    from motionclone_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from motionclone_tpu_torch.models.sparse_controlnet import (SparseControlNetConfig,
                                                                SparseControlNetModel)
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    lap("program_imports")
    dtype = getattr(torch, config["dtype"])

    def make(cls, cfg, key):
        with torch.device("meta"), ref_nets.initialisers_off():
            m = cls(cfg)
        m = m.to(dtype).to_empty(device=device)
        weights.load(m, tensors[key])
        return m

    unet_cfg = UNet3DConfig(**dict(_tuples(config["unet"]),
                                   motion_module=MotionModuleConfig(
                                       **_tuples(config["unet"]["motion_module"]))))
    cn = None
    if config.get("controlnet"):
        c = config["controlnet"]
        cn_cfg = SparseControlNetConfig(**dict(_tuples(c), motion_module=MotionModuleConfig(
            **_tuples(c["motion_module"]))))
        cn = make(SparseControlNetModel, cn_cfg, "controlnet")
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
    lap("program_modules")
    return MotionClonePipeline(
        unet_cfg, NoiseScheduleConfig(**config["noise_schedule"]), infer, unet, vae=vae,
        text_encoder=text, device=device, dtype=dtype, attention_impl=config["attention_impl"],
        controlnet=cn)


def denoiser(pipe):
    return pipe.unet


def words(config: Mapping) -> int:
    """CLIP's ids below BOS and EOS, the vocabulary's last two (49406 and
    49407 in CLIP's)."""
    return config["text_encoder"]["vocab_size"] - 2


def token_ids(config: Mapping, prompts: Sequence[np.ndarray], device) -> torch.Tensor:
    """(rows, T) int64: BOS, the prompt's ids, EOS, and EOS padding to the
    tower's T positions (77), as CLIP's tokenizer frames a prompt."""
    c = config["text_encoder"]
    bos, eos = c["vocab_size"] - 2, c["vocab_size"] - 1
    rows = np.full((len(prompts), c["max_position_embeddings"]), eos, dtype=np.int64)
    rows[:, 0] = bos
    for row, ids in zip(rows, prompts):
        row[1:len(ids) + 1] = ids
    return torch.from_numpy(rows).to(device)


def run_job(pipe, inp, traffic: Mapping, tracer, recorder=None) -> Dict[str, object]:
    from motionclone_tpu_torch.models.sparse_controlnet import scatter_condition
    from motionclone_tpu_torch.utils import rng

    b, f = traffic["batch"], traffic["video"]["frames"]
    g = traffic["schedule"]["guidance_steps"]
    cond = traffic.get("condition")
    with tracer.span("text"):
        text = Conditioning(pipe.encode_text(inp.ids), b)
    with tracer.span("encode"):
        latents = pipe.encode_video(inp.clips, inp.seeds)
    cn_extract = cn_sample = cond_latents = None
    if cond is not None:
        idx = list(cond["image_index"])
        scale = torch.tensor([cond["scale"]] * b, dtype=pipe.dtype).reshape(-1, 1, 1, 1, 1)

        def batched(frames):  # the sweep's _batched_condition of per-example scatters
            pairs = [scatter_condition(frames[e:e + 1].to(pipe.dtype), idx, f) for e in range(b)]
            return (torch.cat([c for c, _ in pairs]), torch.cat([m for _, m in pairs]), scale)

        with tracer.span("condition"):
            cn_extract = batched(latents[:, idx])
    with tracer.span("extract"):
        rep = pipe.extract_motion_representation(latents, text.empty().repeat(b, 1, 1),
                                                 seed=inp.seeds, cn_cond=cn_extract)
    if cond is not None:
        with tracer.span("condition"):
            cond_latents = pipe.encode_video(inp.clips[:, idx], inp.seeds,
                                             rng.CN_IMAGE_POSTERIOR)
            cn_sample = batched(cond_latents)
    marks = [("start", harness.mark(pipe.device))]

    def on_step(i, guided):
        marks.append(("guided" if guided else "vanilla", harness.mark(pipe.device)))
        tracer.switch(None if i + 1 >= len(pipe.fns.timesteps)
                      else "guided_step" if i + 1 < g else "vanilla_step")

    if recorder is not None:
        recorder.arm()
    tracer.switch("guided_step" if g > 0 else "vanilla_step")
    final = pipe.sample_latents(text.negatives(), text.prompts(), rep, seed=inp.seeds,
                                on_step=on_step, cn_cond=cn_sample)
    tracer.switch(None)
    if recorder is not None:
        recorder.disarm()
    videos = []
    with tracer.span("decode"):
        for e in range(b):
            video = pipe.decode_latents(final[e:e + 1])
            video01 = (video.float() / 2 + 0.5).clamp(0.0, 1.0)
            videos.append(torch.round(video01 * 255.0).to(torch.uint8).cpu())
    return dict(text=text.rows, conditioning=text, latents=latents, condition=cond_latents,
                rep=rep, final=final, frames=torch.stack(videos), marks=marks,
                states=dict(recorder.states) if recorder is not None else {},
                grads=dict(recorder.grads) if recorder is not None else {})


def warm_up(pipe, inp, traffic: Mapping) -> None:
    """A job's stages with one guided and one vanilla step in place of the
    schedule."""
    fns = pipe.fns
    t, tp = (int(x) for x in fns.timesteps[:2])
    g = traffic["schedule"]["guidance_steps"]
    # the guided step's timesteps, then the vanilla phase's first
    tv, tpv = int(fns.timesteps[g]), int(fns.timesteps[g + 1])

    class Short:  # the job's stages, sampling replaced by one step of each kind
        def __getattr__(self, name):
            return getattr(pipe, name)

        def sample_latents(self, uncond, cond, rep, seed, on_step=None, cn_cond=None):
            lat = pipe.initial_latents(seed)
            cn = pipe._cn_cond(cn_cond)
            lat, _ = fns.guided_step(lat, t, tp, 1.0, uncond.to(pipe.dtype),
                                     cond.to(pipe.dtype), rep, cn)
            return fns.vanilla_step(lat, tv, tpv, uncond.to(pipe.dtype), cond.to(pipe.dtype), cn)

    run_job(Short(), inp, traffic, Tracer(False))
    harness.sync(pipe.device)


def reference(nets: Mapping, config: Mapping, traffic: Mapping, device, inp,
              program: Mapping, steps: Sequence[int],
              store: Callable[[torch.Tensor], torch.Tensor] = lambda x: x) -> Dict[str, object]:
    return ref_job.Reference(nets, config, traffic, device, store=store).run(
        inp.ids, inp.clips, inp.seeds, program, steps)


def readings(got: Mapping, ref: Mapping) -> Dict[str, float]:
    return {}


def job_flops(config: Mapping, traffic: Mapping) -> Dict[str, float]:
    return flops.job_flops(config, traffic, networks(config))


def kernels() -> Dict:
    return {}

