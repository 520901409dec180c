"""The SD1.5 family's plain reference run of one job, worked out again
from the job's inputs (token ids, clips, example seeds) and weights, one
example at a time (the program's work is per example: its batch is
stacked examples).

It cannot afford the program's 100 steps, so it follows the program step
by step from the program's own state: for each checked step it takes the
program's latents before the step, with the text embeddings, motion
representation and condition the program samples with, and computes the
step from them.  The start (the initial latents) and every stage before
sampling (text, VAE encode, conditions, extraction) it computes from the
inputs alone, and each is judged by itself; the decode it computes from
the program's final latents.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import torch

from bench_h100.reference import diffusion as D
from bench_h100.reference.nets import scatter_condition

FRAME_CHUNK = 4  # VAE frames at once


def _vae_frames(fn, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([fn(x[i:i + FRAME_CHUNK]) for i in range(0, x.shape[0], FRAME_CHUNK)])


def encode(vae, frames: torch.Tensor, seed: int, domain: int, scaling: float) -> torch.Tensor:
    """Pixels (N, H, W, 3) -> scaled latents (1, N, h, w, 4), the
    posterior drawn from ``domain`` of ``seed``."""
    mean, logvar = (torch.cat(t) for t in zip(*[
        vae.encode(frames[i:i + FRAME_CHUNK]) for i in range(0, frames.shape[0], FRAME_CHUNK)]))
    eps = D.draw_normal((1,) + tuple(mean.shape), seed, domain, frames.device)
    z = mean[None] + torch.exp(0.5 * logvar[None].clamp(-30.0, 20.0)) * eps
    return z * scaling


def decode(vae, latents: torch.Tensor, scaling: float) -> torch.Tensor:
    """Latents (F, h, w, 4) -> uint8 frames (F, H, W, 3)."""
    video = _vae_frames(vae.decode, latents / scaling)
    return torch.round((video / 2 + 0.5).clamp(0.0, 1.0) * 255.0).to(torch.uint8)


class Reference:
    """The reference networks (f32, or the control's fp8) for a cell."""

    def __init__(self, nets: Mapping, config: Mapping, traffic: Mapping, device,
                 store: Callable[[torch.Tensor], torch.Tensor] = lambda x: x):
        self.unet, self.vae, self.clip = nets["unet"], nets["vae"], nets["text_encoder"]
        self.cn = nets.get("controlnet")
        for m in self.unet.modules():
            if hasattr(m, "recompute"):
                m.recompute = True
        self.config, self.traffic, self.device, self.store = config, traffic, device, store
        sched = traffic["schedule"]
        self.sched = D.Schedule(config["noise_schedule"], sched, device)
        self.guidance = tuple(sched["motion_guidance_blocks"])
        self.cut = int(self.guidance[-1].rsplit(".", 1)[-1])  # the program's guidance_cut_index
        self.scaling = config["vae"]["scaling_factor"]
        self.cond = traffic.get("condition")

    def _condition(self, frames):
        c, m = scatter_condition(frames, self.cond["image_index"],
                                 self.traffic["video"]["frames"])
        return c, m, float(self.cond["scale"])

    def _residuals(self, x, t, emb, cn):
        return None if cn is None else self.cn(x, t, emb, *cn)

    def step(self, i: int, x: torch.Tensor, emb_u, emb_c, rep, cn):
        """Step i of the schedule from latents ``x`` (1, F, h, w, 4) ->
        (the latents after it, the same step without the guidance's
        score, the guidance loss's gradient to ``x`` or None)."""
        s = self.traffic["schedule"]
        t = int(self.sched.timesteps[i])
        with torch.no_grad():
            res_u, res_c = self._residuals(x, t, emb_u, cn), self._residuals(x, t, emb_c, cn)
            pred_u, _ = self.unet(x, t, emb_u, residuals=res_u)
            grad = score = None
            if i < self.sched.guided:
                leaf = x.detach().requires_grad_(True)
                with torch.enable_grad():
                    pred_c, probs = self.unet(leaf, t, emb_c, self.guidance, res_c,
                                              grad_cut=self.cut)
                    loss = s["motion_guidance_weight"] * D.guidance_loss(probs, rep)
                    (grad,) = torch.autograd.grad(loss, leaf)
                score = grad * float(self.sched.ramp[i])
            else:
                pred_c, _ = self.unet(x, t, emb_c, residuals=res_c)
            eps = pred_c + s["cfg_scale"] * (pred_c - pred_u)
            return (self.store(self.sched.step(eps, i, x, score)), self.sched.step(eps, i, x),
                    grad)

    @torch.no_grad()
    def run(self, ids: torch.Tensor, clips: torch.Tensor, seeds: Sequence[int],
            program: Mapping[str, object], steps: Sequence[int]) -> Dict[str, object]:
        """The reference's outputs of a job: ``text`` (2B+1, 77, D),
        ``latents`` (B, F, h, w, 4), ``condition`` (B, N, h, w, 4) or None,
        ``rep`` {module: (values, indices)}, ``init`` (B, F, h, w, 4),
        ``steps`` {i: the step's output from the program's state before
        it: its latents ``program["states"][i]``, text embeddings (the
        example's rows of its ``conditioning``), motion representation
        and condition},
        ``unguided`` {i: the same step without the guidance's score},
        ``grads`` {guided i: the guidance loss's gradient to the latents},
        ``frames`` (B, F, H, W, 3) uint8 decoded from the program's
        ``final`` latents."""
        store, b = self.store, len(seeds)
        text = store(self.clip(ids))
        sched, s = self.sched, self.traffic["schedule"]
        out = {"text": text, "latents": [], "condition": [], "rep": [], "init": [],
               "steps": {i: [] for i in steps}, "unguided": {i: [] for i in steps},
               "grads": {i: [] for i in steps if i < sched.guided}, "frames": []}
        for e, seed in enumerate(seeds):
            lat = store(encode(self.vae, clips[e], seed, D.VAE_POSTERIOR, self.scaling))
            out["latents"].append(lat)
            cn_extract = cn_sample = None
            if self.cond is not None:
                idx = self.cond["image_index"]
                cn_extract = self._condition(lat[:, idx])
                frames = store(encode(self.vae, clips[e][idx], seed, D.CN_IMAGE_POSTERIOR,
                                      self.scaling))
                out["condition"].append(frames)
                cn_sample = self._condition(frames)
            noise = D.draw_normal(lat.shape, seed, D.EXTRACT_NOISE, self.device)
            t = s["add_noise_step"]
            noisy = sched.add_noise(t, lat, noise)
            empty = text[2 * b:2 * b + 1]
            _, probs = self.unet(noisy, t, empty, self.guidance,
                                 self._residuals(noisy, t, empty, cn_extract),
                                 max_up_block=self.cut)
            rep = {k: D.top1(p) for k, p in probs.items()}
            rep = {k: (store(v), i) for k, (v, i) in rep.items()}
            out["rep"].append(rep)
            out["init"].append(store(D.draw_normal(lat.shape, seed, D.INIT_LATENTS, self.device)))
            # the program's state before a step: its latents, text, motion
            # representation and condition
            negative, prompt = (t.float() for t in program["conditioning"].example(e))
            prep = {k: (v[e:e + 1].float(), i[e:e + 1]) for k, (v, i) in program["rep"].items()}
            pcn = (None if self.cond is None
                   else self._condition(program["condition"][e:e + 1].float()))
            for i in steps:
                x = program["states"][i][e:e + 1].float()
                after, unguided, grad = self.step(i, x, negative, prompt, prep, pcn)
                out["steps"][i].append(after)
                out["unguided"][i].append(unguided)
                if grad is not None:
                    out["grads"][i].append(grad)
            out["frames"].append(decode(self.vae, program["final"][e].float(), self.scaling))
        cat = lambda xs: torch.cat(xs) if xs else None
        return {
            "text": text, "latents": cat(out["latents"]), "condition": cat(out["condition"]),
            "rep": {k: (torch.cat([r[k][0] for r in out["rep"]]),
                        torch.cat([r[k][1] for r in out["rep"]])) for k in out["rep"][0]},
            "init": cat(out["init"]), "steps": {i: cat(v) for i, v in out["steps"].items()},
            "unguided": {i: cat(v) for i, v in out["unguided"].items()},
            "grads": {i: cat(v) for i, v in out["grads"].items()},
            "frames": torch.stack(out["frames"]),
        }
