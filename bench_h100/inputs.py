"""The one general generator of a traffic mix's jobs, from its data file
(``traffic/<mix>.json``) and the run's seed.

A job is one batch of ``batch`` examples.  Each example gets its own seed,
prompt and reference clip; the seed of the run fixes them all, so the
same seed gives the same jobs, and every seed gives the same sizes: the
model family frames every prompt to its towers' fixed positions and the
clips are always ``frames`` x ``height`` x ``width``, so a seed changes
values and never the work.

* Prompts stand in for a tokenizer, which needs vocabulary files: a prompt
  is a seeded number (``prompt_tokens``) of ids drawn below the family's
  ``words``.  A job's prompts are the examples', the negative prompt
  (``negative_prompt_tokens`` ids, one per run) once per example, then the
  empty prompt (the sweep's one text call of 2B+1 rows); the family's
  ``token_ids`` frames and pads them for each of its text towers.
* A reference clip is a seeded smooth texture (``texture_cells`` random
  values a side, upsampled) seen through a window that zooms or pans by
  ``rate`` a frame: camera motion, so the motion representation has
  something to extract.  Values in [-1, 1].
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping

import numpy as np
import torch
from torch.nn import functional as F

SEED_DOMAIN = 101  # the inputs' stream of the run's seed (weights.py has 100)


@dataclasses.dataclass
class JobInputs:
    ids: object             # the family's token ids: prompts, negatives, the empty prompt
    clips: torch.Tensor     # (B, F, H, W, 3) f32 in [-1, 1]
    seeds: List[int]        # one per example


def _texture(gen: torch.Generator, cells: int, size: int, device) -> torch.Tensor:
    coarse = torch.randn(1, 3, cells, cells, generator=gen, device=device)
    fine = F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)
    return torch.tanh(fine)


def _clip(texture: torch.Tensor, motion: str, rate: float, frames: int, h: int, w: int):
    """(F, H, W, 3): frame k of the texture through a window zoomed or
    panned by k * rate, inside the canvas."""
    mats = []
    for k in range(frames):
        s, tx, ty = 0.5, 0.0, 0.0  # the window: half the canvas, centred
        d = k * rate
        if motion == "zoom_in":
            s = 0.5 / (1 + d)
        elif motion == "zoom_out":
            s = 0.5 / (1 + rate * (frames - 1 - k))
        elif motion == "pan_left":
            tx = -d
        elif motion == "pan_right":
            tx = d
        elif motion == "pan_up":
            ty = -d
        elif motion == "pan_down":
            ty = d
        else:
            raise ValueError(f"unknown clip motion {motion!r}")
        mats.append([[s, 0.0, tx], [0.0, s, ty]])
    theta = torch.tensor(mats, dtype=torch.float32, device=texture.device)
    grid = F.affine_grid(theta, (frames, 3, h, w), align_corners=False)
    out = F.grid_sample(texture.expand(frames, -1, -1, -1), grid, mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).contiguous()


def make_job(traffic: Mapping, family, config: Mapping, seed: int, job: int,
             device) -> JobInputs:
    """Job ``job`` (0, 1, ...; -1 is the warm-up's) of the run ``seed``, its
    token ids made by the model ``family`` for ``config``."""
    ss = np.random.SeedSequence([seed, SEED_DOMAIN, job + 1])
    rng = np.random.default_rng(ss)
    b, video, clip = traffic["batch"], traffic["video"], traffic["clip"]
    lo, hi = traffic["prompt_tokens"]
    words = family.words(config)
    negative = np.random.default_rng([seed, SEED_DOMAIN]).integers(
        0, words, traffic["negative_prompt_tokens"])
    prompts = ([rng.integers(0, words, int(rng.integers(lo, hi + 1))) for _ in range(b)]
               + [negative] * b + [rng.integers(0, words, 0)])
    seeds = [int(s) for s in rng.integers(0, 2 ** 31 - 1, b)]
    motions = [clip["motions"][int(i)] for i in rng.integers(0, len(clip["motions"]), b)]
    gen = torch.Generator(device=device).manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    h, w, f = video["height"], video["width"], video["frames"]
    clips = torch.stack([
        _clip(_texture(gen, clip["texture_cells"], 2 * max(h, w), device), m, clip["rate"],
              f, h, w)
        for m in motions])
    return JobInputs(family.token_ids(config, prompts, device), clips, seeds)
