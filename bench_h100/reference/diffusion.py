"""The plain reference's sampling arithmetic: the DDIM schedule and step,
MotionClone's uneven guided schedule, its loss ramp, the top-1 motion
representation and the guidance loss, and the domain-separated seeded
noise draws.  A frozen copy of the measured program's equations (epsilon
prediction, eta 0, no thresholding or clipping: the configurations'
schedule)."""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

# the seed's noise domains: the reference clip's VAE posterior, the
# extraction's add-noise draw, the initial latents, the i2v condition
# image's VAE posterior
VAE_POSTERIOR, EXTRACT_NOISE, INIT_LATENTS, CN_IMAGE_POSTERIOR = 1, 2, 3, 4


def draw_normal(shape: Sequence[int], seed: int, domain: int, device) -> torch.Tensor:
    """f32 standard normal noise from a generator on ``device`` seeded with
    the 64-bit mix of (seed, domain)."""
    mixed = np.random.SeedSequence([seed, domain]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(mixed))
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)


class Schedule:
    """The configuration's noise schedule and the traffic's sampling
    schedule: timesteps, previous timesteps, the guided steps' loss ramp."""

    def __init__(self, noise: Mapping, sampling: Mapping, device):
        if noise["beta_schedule"] != "linear" or noise["prediction_type"] != "epsilon" \
                or noise["clip_sample"] or noise["thresholding"]:
            raise ValueError("the reference has the linear, epsilon, unclipped schedule only")
        T = noise["num_train_timesteps"]
        betas = np.linspace(noise["beta_start"], noise["beta_end"], T, dtype=np.float64)
        self.alphas = torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32, device=device)
        self.final = torch.tensor(1.0 if noise["set_alpha_to_one"] else float(self.alphas[0]),
                                  dtype=torch.float32, device=device)
        n, g = sampling["inference_steps"], sampling["guidance_steps"]
        split = int((1 - sampling["guidance_fraction"]) * T)
        guided = np.linspace(split, T - 1, g).round()[::-1].astype(np.int64)
        vanilla = np.linspace(0, split - 1, n - g).round()[::-1].astype(np.int64)
        self.timesteps = np.concatenate([guided, vanilla])
        self.prev = np.concatenate([self.timesteps[1:], [-1]])
        self.guided = g
        warm, cool = sampling["warm_up_steps"], sampling["cool_up_steps"]
        ramp = np.ones(g, dtype=np.float32)
        for i in range(g):
            if warm > 0 and i < warm:
                ramp[i] *= (i + 1) / warm
            if cool > 0 and i > g - cool:
                ramp[i] *= (g - i) / cool
        self.ramp = ramp

    def alpha(self, t: int) -> torch.Tensor:
        return self.alphas[int(t)] if t >= 0 else self.final

    def add_noise(self, t: int, x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        a = self.alpha(t)
        return a ** 0.5 * x0 + (1.0 - a) ** 0.5 * noise

    def step(self, eps: torch.Tensor, i: int, x: torch.Tensor, score=None) -> torch.Tensor:
        """DDIM step i (eta 0); the guidance score enters on the predicted
        noise after the x0 prediction."""
        a_t, a_prev = self.alpha(self.timesteps[i]), self.alpha(self.prev[i])
        x0 = (x - (1 - a_t) ** 0.5 * eps) / a_t ** 0.5
        if score is not None:
            eps = eps - (1.0 - a_t) ** 0.5 * score
        return a_prev ** 0.5 * x0 + (1.0 - a_prev) ** 0.5 * eps


def top1(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of each attention row's maximum, [..., F, 1]."""
    return probs.amax(dim=-1, keepdim=True), probs.argmax(dim=-1, keepdim=True)


def guidance_loss(probs: Mapping[str, torch.Tensor],
                  rep: Mapping[str, Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """Sum over modules of the mean squared gap between the current
    probabilities at the saved argmax and the saved maxima, a per-example
    mean summed over the batch."""
    total = 0.0
    for name in sorted(probs):
        values, indices = rep[name]
        sq = (torch.gather(probs[name], -1, indices.long()) - values) ** 2
        total = total + (sq.reshape(sq.shape[0], -1).mean(dim=1)).sum()
    return total


MotionRep = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
