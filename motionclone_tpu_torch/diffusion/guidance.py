"""Sparse temporal-attention motion representation and guidance loss.

Port of ``motionclone_tpu/diffusion/guidance.py``.  A motion representation
maps a module name to ``(values, indices)``: the top-1 probability
(float32 [..., frames, 1]) and its argmax position (uint8 [..., frames, 1])
of each row of a temporal-attention probability map [..., frames, frames],
keyed by the attention module's dotted name
(``up_blocks.1.motion_modules.0.temporal_transformer.transformer_blocks.0.attention_blocks.0``).

On disk it is the JAX package's ``.npz`` (``name#values`` f32,
``name#indices`` u8, an optional ``#meta`` JSON string), so a file written
by one package loads in the other, or the reference's ``.pt`` payload
``{name: [values, indices]}`` with (batch * pixels, heads, frames, 1)
arrays.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Optional, Tuple

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


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------


def _numpy(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def save_motion_representation(
    path: str,
    rep: Mapping[str, Tuple[Any, Any]],
    meta: Optional[Mapping[str, Any]] = None,
) -> None:
    """Write {name: (values, indices)} (tensors or arrays) to an ``.npz``,
    with ``meta`` (the settings it was extracted under) as JSON; a path
    ending in ``.pt``/``.pth`` gets the reference's torch payload, which
    carries no meta."""
    if path.endswith((".pt", ".pth")):
        payload = {}
        for name, (values, indices) in rep.items():
            v, i = _numpy(values, np.float32), _numpy(indices, np.uint8)
            # (b, s, heads, f, 1) -> the reference's (b * s, heads, f, 1)
            payload[name] = [torch.from_numpy(v.reshape((-1,) + v.shape[2:]).copy()),
                             torch.from_numpy(i.reshape((-1,) + i.shape[2:]).copy())]
        torch.save(payload, path)
        return
    flat = {}
    for name, (values, indices) in rep.items():
        flat[f"{name}#values"] = _numpy(values, np.float32)
        flat[f"{name}#indices"] = _numpy(indices, np.uint8)
    if meta is not None:
        flat["#meta"] = np.asarray(json.dumps(dict(meta), sort_keys=True))
    np.savez(path, **flat)


def load_motion_representation(path: str) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{name: (values f32, indices uint8)} CPU tensors from an ``.npz`` or
    a reference ``.pt``/``.pth``, whose (pixels, heads, frames, 1) arrays
    (batch 1, as in every reference flow) become (1, pixels, heads,
    frames, 1)."""
    rep: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    if path.endswith((".pt", ".pth")):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        for name, (values, indices) in payload.items():
            v, i = values.to(torch.float32), indices.to(torch.uint8)
            if v.ndim != 4 or v.shape[-1] != 1:
                raise ValueError(
                    f"{path}: module {name!r} has shape {tuple(v.shape)}; expected the "
                    f"reference layout (pixels, heads, frames, 1)")
            rep[name] = (v[None], i[None])
        return rep
    with np.load(path) as data:
        for key in data.files:
            if key.endswith("#values"):
                name = key[: -len("#values")]
                rep[name] = (torch.from_numpy(data[key].astype(np.float32)),
                             torch.from_numpy(data[f"{name}#indices"].astype(np.uint8)))
    return rep


def load_motion_representation_meta(path: str) -> Optional[Dict[str, Any]]:
    """The meta an ``.npz`` was saved with, or None (``.pt`` payloads and
    files saved without meta)."""
    if path.endswith((".pt", ".pth")):
        return None
    with np.load(path) as data:
        if "#meta" not in data.files:
            return None
        return json.loads(str(data["#meta"]))
