"""Sparse temporal-attention motion representation and guidance loss.

Port of ``motionclone_tpu/diffusion/guidance.py``.  A motion representation
maps a module name to ``(values, indices)``: the top-1 probability
(float32 [..., frames, 1]) and its argmax position (uint8 [..., frames, 1])
of each row of a temporal-attention probability map [..., frames, frames].
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch


def sparsify_top1(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 (value, index) of each attention row: (f32, uint8), [..., f, 1]."""
    values = probs.amax(dim=-1, keepdim=True)
    indices = probs.argmax(dim=-1, keepdim=True)  # first maximum, as jnp.argmax
    return values.float(), indices.to(torch.uint8)


def gather_sparse_probs(probs: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Probabilities at the saved argmax positions (``torch.gather`` on the
    last axis; uint8 indices accepted)."""
    return torch.gather(probs, -1, indices.long())


def motion_guidance_loss(
    current_probs: Mapping[str, torch.Tensor],
    motion_representation: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
    group=None,
) -> torch.Tensor:
    """Sum over modules (sorted by name) of the MSE between the gathered
    current probabilities and the saved max values, in float32.  The MSE is
    a per-example mean summed over the leading batch axis: for batch 1 it is
    the reference's plain mean.

    ``group`` (a ``parallel.frames.FrameGroup``): the probabilities and the
    representation hold the rank's query frames only, and the rank returns
    its *partial*: its local sum over the global element count, so that the
    ranks' partials sum to the loss.  Nothing is summed over the ranks here:
    differentiating the partial is right, because the terms that cross ranks
    arrive through the key/value gathers' backward.  A caller who wants the
    loss's value sums the partials outside the differentiated function."""
    losses = []
    for name in sorted(current_probs.keys()):
        values, indices = motion_representation[name]
        picked = gather_sparse_probs(current_probs[name].float(), indices)
        sq = (picked - values.float()) ** 2
        per_example = sq.reshape(sq.shape[0], -1).sum(dim=1)
        numel = int(np.prod(sq.shape[1:])) * (1 if group is None else group.size)
        losses.append((per_example / numel).sum())
    return torch.stack(losses).sum()


def ramp_scales(
    guidance_steps: int, warm_up_steps: int, cool_up_steps: int
) -> np.ndarray:
    """Per-step loss multiplier of the guided phase: warm-up
    (step+1)/warm_up for step < warm_up and cool-down (guidance-step)/cool for
    step > guidance - cool, applied independently."""
    scales = np.ones(guidance_steps, dtype=np.float32)
    for i in range(guidance_steps):
        if warm_up_steps > 0 and i < warm_up_steps:
            scales[i] *= (i + 1) / warm_up_steps
        if cool_up_steps > 0 and i > guidance_steps - cool_up_steps:
            scales[i] *= (guidance_steps - i) / cool_up_steps
    return scales
