"""The model FLOPs of one job, counted once per configuration and cell by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
the meta device, at the cell's shapes: the same work whatever implements
it.  A job is what the SD1.5 family's ``run_job`` drives
(``families/sd15_animatediff.py``): CLIP on 2B+1 rows, the VAE
encode of B clips (and of B condition images), the extraction, every
guided step (the controlnet on the CFG pair, the unconditional forward,
the conditional forward and its backward to the latents through the
guidance cut), every vanilla step (the controlnet and the UNet on the CFG
pair) and the decode of B clips."""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100.reference import diffusion


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def job_flops(config: Mapping, traffic: Mapping, m: Mapping[str, torch.nn.Module]
              ) -> Dict[str, float]:
    """{component: FLOPs of one occurrence, ..., "job": FLOPs of a job},
    over the family's reference networks ``m`` on the meta device."""
    unet, vae, clip, cn = m["unet"], m["vae"], m["text_encoder"], m.get("controlnet")
    b, video, sched = traffic["batch"], traffic["video"], traffic["schedule"]
    f, hh, ww = video["frames"], video["height"], video["width"]
    lat = (b, f, hh // 8, ww // 8, config["unet"]["in_channels"])
    meta = dict(device="meta")
    ctx = torch.empty(b, config["text_encoder"]["max_position_embeddings"],
                      config["unet"]["cross_attention_dim"], **meta)
    guidance = tuple(sched["motion_guidance_blocks"])
    cut = int(guidance[-1].rsplit(".", 1)[-1])
    cond = traffic.get("condition")

    def residuals(rows):
        if cn is None or cond is None:
            return None
        x = torch.empty(rows, *lat[1:], **meta)
        c = torch.empty(rows, f, hh // 8, ww // 8, config["controlnet"]["conditioning_channels"],
                        **meta)
        mask = torch.empty(rows, f, hh // 8, ww // 8, 1, **meta)
        return cn(x, 1, ctx[:1].expand(rows, -1, -1), c, mask, 1.0)

    def half(res, sl):
        return None if res is None else ([d[sl] for d in res[0]], res[1][sl])

    counts: Dict[str, float] = {}
    counts["text"] = _count(lambda: clip(torch.zeros(2 * b + 1, ctx.shape[1], dtype=torch.long,
                                                     **meta)))
    counts["vae_encode"] = _count(lambda: vae.encode(torch.empty(b * f, hh, ww, 3, **meta)))
    if cond is not None:
        n = len(cond["image_index"])
        counts["condition_encode"] = _count(
            lambda: vae.encode(torch.empty(b * n, hh, ww, 3, **meta)))
    rep = {}

    def extract():
        res = residuals(b)
        _, probs = unet(torch.empty(lat, **meta), 1, ctx, guidance, res, max_up_block=cut)
        rep.update({k: diffusion.top1(p) for k, p in probs.items()})

    counts["extract"] = _count(extract)

    def guided():
        res = residuals(2 * b)
        with torch.no_grad():
            unet(torch.empty(lat, **meta), 1, ctx, residuals=half(res, slice(None, b)))
        leaf = torch.empty(lat, **meta, requires_grad=True)
        with torch.enable_grad():
            # a non-leaf input: the counter's module hooks refuse a leaf under autograd.grad
            _, probs = unet(leaf * 1.0, 1, ctx, guidance, half(res, slice(b, None)), grad_cut=cut)
            torch.autograd.grad(diffusion.guidance_loss(probs, rep), leaf)

    def vanilla():
        res = residuals(2 * b)
        with torch.no_grad():
            unet(torch.empty(2 * b, *lat[1:], **meta), 1, torch.cat([ctx, ctx]), residuals=res)

    counts["guided_step"] = _count(guided)
    counts["vanilla_step"] = _count(vanilla)
    counts["vae_decode"] = _count(lambda: vae.decode(torch.empty(b * f, *lat[2:], **meta)))
    g = sched["guidance_steps"]
    v = sched["inference_steps"] - g
    counts["job"] = (sum(c for k, c in counts.items() if not k.endswith("_step"))
                     + g * counts["guided_step"] + v * counts["vanilla_step"])
    return counts
