"""The SDXL family's plain reference run of one job: ``job.py``'s, with
SDXL's text (both towers' penultimate states joined, bigG's pooled text)
and conditioning (the context, the pooled text and the size and crop ids
of the video), and DDIM over SDXL's ``scaled_linear`` betas.  As there, it
follows the program step by step from the program's own state, and checks
the text, the VAE encode, the extraction and the start from the inputs
alone and the decode from the program's final latents.  The guided
backward recomputes every resnet, motion module and transformer layer
(``sdxl_nets``), so it fits the card in f32."""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from bench_h100.reference import diffusion as D
from bench_h100.reference import job
from bench_h100.reference.sdxl_nets import encode_text


class Schedule(D.Schedule):
    """``diffusion.Schedule`` over ``scaled_linear`` betas: linear in their
    square root."""

    def __init__(self, noise: Mapping, sampling: Mapping, device):
        if noise["beta_schedule"] != "scaled_linear":
            raise ValueError("the SDXL reference has the scaled_linear schedule only")
        super().__init__(dict(noise, beta_schedule="linear"), sampling, device)
        betas = np.linspace(noise["beta_start"] ** 0.5, noise["beta_end"] ** 0.5,
                            noise["num_train_timesteps"], dtype=np.float64) ** 2
        self.alphas = torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32, device=device)
        self.final = torch.tensor(1.0 if noise["set_alpha_to_one"] else float(self.alphas[0]),
                                  dtype=torch.float32, device=device)


def time_ids(video: Mapping, rows: int, device) -> torch.Tensor:
    """(rows, 6) f32: the original size, a crop at (0, 0), the target size."""
    h, w = video["height"], video["width"]
    return torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32,
                        device=device).repeat(rows, 1)


class Reference(job.Reference):
    """The SDXL reference networks (f32, or the control's fp8) for a cell."""

    def __init__(self, nets: Mapping, config: Mapping, traffic: Mapping, device,
                 store: Callable[[torch.Tensor], torch.Tensor] = lambda x: x):
        self.nets = nets
        self.unet, self.vae = nets["unet"], nets["vae"]
        self.cn = None
        self.unet.set_recompute(True)
        self.config, self.traffic, self.device, self.store = config, traffic, device, store
        sched = traffic["schedule"]
        self.sched = Schedule(config["noise_schedule"], sched, device)
        self.guidance = tuple(sched["motion_guidance_blocks"])
        self.cut = int(self.guidance[-1].rsplit(".", 1)[-1])
        self.scaling = config["vae"]["scaling_factor"]
        self.cond = None

    @torch.no_grad()
    def run(self, ids, clips: torch.Tensor, seeds: Sequence[int],
            program: Mapping[str, object], steps: Sequence[int]) -> Dict[str, object]:
        """``job.Reference.run``'s outputs, ``text`` the joined context
        (2B+1, 77, 2048), with ``pooled`` (2B+1, 1280); ``program``'s
        ``conditioning`` gives each example's (negative, prompt) context and
        pooled text, and the checked steps take the size and crop ids from
        the traffic's video (``time_ids``), not from the program."""
        store, b = self.store, len(seeds)
        context, pooled = encode_text(self.nets, ids)
        text, pooled = store(context), store(pooled)
        sched, s = self.sched, self.traffic["schedule"]
        out = {"latents": [], "rep": [], "init": [], "steps": {i: [] for i in steps},
               "unguided": {i: [] for i in steps},
               "grads": {i: [] for i in steps if i < sched.guided}, "frames": []}
        ids_1 = time_ids(self.traffic["video"], 1, self.device)
        for e, seed in enumerate(seeds):
            lat = store(job.encode(self.vae, clips[e], seed, D.VAE_POSTERIOR, self.scaling))
            out["latents"].append(lat)
            noise = D.draw_normal(lat.shape, seed, D.EXTRACT_NOISE, self.device)
            t = s["add_noise_step"]
            noisy = sched.add_noise(t, lat, noise)
            empty = (text[2 * b:2 * b + 1], pooled[2 * b:2 * b + 1], ids_1)
            _, probs = self.unet(noisy, t, empty, self.guidance, max_up_block=self.cut)
            rep = {k: D.top1(p) for k, p in probs.items()}
            out["rep"].append({k: (store(v), i) for k, (v, i) in rep.items()})
            out["init"].append(store(D.draw_normal(lat.shape, seed, D.INIT_LATENTS, self.device)))
            negative, prompt = ((c[0].float(), c[1].float(), ids_1)
                                for c in program["conditioning"].example(e))
            prep = {k: (v[e:e + 1].float(), i[e:e + 1]) for k, (v, i) in program["rep"].items()}
            for i in steps:
                x = program["states"][i][e:e + 1].float()
                after, unguided, grad = self.step(i, x, negative, prompt, prep, None)
                out["steps"][i].append(after)
                out["unguided"][i].append(unguided)
                if grad is not None:
                    out["grads"][i].append(grad)
            out["frames"].append(job.decode(self.vae, program["final"][e].float(), self.scaling))
        cat = lambda xs: torch.cat(xs) if xs else None
        return {
            "text": text, "pooled": pooled, "latents": cat(out["latents"]), "condition": None,
            "rep": {k: (torch.cat([r[k][0] for r in out["rep"]]),
                        torch.cat([r[k][1] for r in out["rep"]])) for k in out["rep"][0]},
            "init": cat(out["init"]), "steps": {i: cat(v) for i, v in out["steps"].items()},
            "unguided": {i: cat(v) for i, v in out["unguided"].items()},
            "grads": {i: cat(v) for i, v in out["grads"].items()},
            "frames": torch.stack(out["frames"]),
        }
