"""LoRA merging on flat diffusers-key state dicts.

Port of ``motionclone_tpu/weights/lora.py``:

* ``merge_kohya_lora``: community ``lora_unet_*`` / ``lora_te_*``
  underscore naming with per-pair ``.alpha`` keys;
* ``merge_diffusers_lora``: ``...processor.to_q_lora.down.weight`` naming,
  used by AnimateDiff motion LoRAs and domain adapters.

Both add ``alpha * up @ down`` to the target weight.  The product and the
sum run in float32 numpy, as the JAX package computes them, so both
packages merge to the same bits; the result keeps the target's dtype.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _matmul_delta(up: torch.Tensor, down: torch.Tensor) -> np.ndarray:
    if up.ndim == 4:  # 1x1 conv lora
        up2 = _f32(up).reshape(up.shape[0], up.shape[1])
        down2 = _f32(down).reshape(down.shape[0], down.shape[1])
        return (up2 @ down2)[:, :, None, None]
    return _f32(up) @ _f32(down)


def _merged(target: torch.Tensor, alpha: float, delta: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(_f32(target) + alpha * delta).to(target.dtype)


def _underscore_index(base: Mapping[str, torch.Tensor]) -> Dict[str, str]:
    """{'down_blocks_0_attentions_0_..._to_q': 'down_blocks.0.….to_q.weight'}"""
    return {key[: -len(".weight")].replace(".", "_"): key
            for key in base if key.endswith(".weight")}


def merge_kohya_lora(
    base: Mapping[str, torch.Tensor],
    lora: Mapping[str, torch.Tensor],
    alpha: float = 0.6,
    prefix: str = "lora_unet",
) -> StateDict:
    """Merge a kohya-format LoRA into a copy of ``base``; raises
    ``KeyError`` for a target the base does not have."""
    out = dict(base)
    index = _underscore_index(base)
    for key in lora:
        if ".alpha" in key or "lora_up" in key or not key.startswith(prefix + "_"):
            continue
        if "lora_down" not in key:
            continue
        name = key.split(".")[0][len(prefix) + 1:]
        target = index.get(name)
        if target is None:
            raise KeyError(f"LoRA target not found in base model: {name}")
        delta = _matmul_delta(lora[key.replace("lora_down", "lora_up")], lora[key])
        out[target] = _merged(out[target], alpha, delta)
    return out


def merge_diffusers_lora(
    base: Mapping[str, torch.Tensor],
    lora: Mapping[str, torch.Tensor],
    alpha: float = 1.0,
) -> StateDict:
    """Merge a diffusers processor-format LoRA into a copy of ``base``;
    raises ``KeyError`` for a target the base does not have."""
    out = dict(base)
    for key in lora:
        if "up." in key:
            continue
        up_key = key.replace(".down.", ".up.")
        model_key = (
            key.replace("processor.", "")
            .replace("_lora", "")
            .replace("down.", "")
            .replace("up.", "")
        )
        model_key = model_key.replace("to_out.", "to_out.0.")
        if model_key not in out:
            raise KeyError(f"LoRA target not found in base model: {model_key}")
        delta = _matmul_delta(lora[up_key], lora[key])
        out[model_key] = _merged(out[model_key], alpha, delta)
    return out
