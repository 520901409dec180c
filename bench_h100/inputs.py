"""The one general generator of a traffic mix's jobs, from its data file
(``traffic/<mix>.json``) and the run's seed.

A job is one batch of ``batch`` examples.  Each example gets its own seed,
token ids and reference clip; the seed of the run fixes them all, so the
same seed gives the same jobs, and every seed gives the same sizes: the
ids are always 77 positions and the clips always ``frames`` x ``height``
x ``width``, so a seed changes values and never the work.

* Token ids stand in for the CLIP tokenizer, which needs vocabulary files:
  BOS, a seeded number (``prompt_tokens``) of ids, EOS, and EOS padding to
  77 positions (BOS and EOS are the vocabulary's last two ids, 49406 and
  49407 in CLIP's).  A job's id batch is the examples' prompts, the negative
  prompt once per example, then the empty prompt (the sweep's one CLIP
  call of 2B+1 rows).
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

TOKENS = 77
SEED_DOMAIN = 101  # the inputs' stream of the run's seed (weights.py has 100)


@dataclasses.dataclass
class JobInputs:
    ids: torch.Tensor       # (2B+1, 77) int64: prompts, negatives, the empty prompt
    clips: torch.Tensor     # (B, F, H, W, 3) f32 in [-1, 1]
    seeds: List[int]        # one per example


def _ids(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    bos, eos = vocab - 2, vocab - 1
    row = np.full(TOKENS, eos, dtype=np.int64)
    row[0] = bos
    row[1:n + 1] = rng.integers(0, bos, n)
    return row


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


def make_job(traffic: Mapping, vocab: int, seed: int, job: int, device) -> JobInputs:
    """Job ``job`` (0, 1, ...; -1 is the warm-up's) of the run ``seed``."""
    ss = np.random.SeedSequence([seed, SEED_DOMAIN, job + 1])
    rng = np.random.default_rng(ss)
    b, video, clip = traffic["batch"], traffic["video"], traffic["clip"]
    lo, hi = traffic["prompt_tokens"]
    negative = _ids(np.random.default_rng([seed, SEED_DOMAIN]), traffic["negative_prompt_tokens"],
                    vocab)
    ids = ([_ids(rng, int(rng.integers(lo, hi + 1)), vocab) for _ in range(b)]
           + [negative] * b + [_ids(rng, 0, vocab)])
    seeds = [int(s) for s in rng.integers(0, 2 ** 31 - 1, b)]
    motions = [clip["motions"][int(i)] for i in rng.integers(0, len(clip["motions"]), b)]
    gen = torch.Generator(device=device).manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    h, w, f = video["height"], video["width"], video["frames"]
    clips = torch.stack([
        _clip(_texture(gen, clip["texture_cells"], 2 * max(h, w), device), m, clip["rate"],
              f, h, w)
        for m in motions])
    return JobInputs(torch.from_numpy(np.stack(ids)).to(device), clips, seeds)
