"""State-dict merging and the strict check before a load.

Port of the parts of ``motionclone_tpu/weights/convert.py`` the port needs:
its modules' keys are already the diffusers / Hugging Face keys, so there is
no key or layout conversion.  :func:`check_state_dict` is the counterpart of
``validate_against``: a loaded dict must hold exactly the module's keys, at
its shapes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

StateDict = Dict[str, torch.Tensor]

# buffers that checkpoints carry and the port's modules compute instead
DEFAULT_SKIP_SUBSTRINGS: Tuple[str, ...] = ("pos_encoder.pe",)


def merge_state_dicts(
    base: Mapping[str, torch.Tensor],
    overlay: Mapping[str, torch.Tensor],
    *,
    filter_substring: Optional[str] = None,
) -> StateDict:
    """Overlay (optionally filtered) keys onto a copy of ``base``.  The
    motion-module merge is ``merge_state_dicts(unet, mm,
    filter_substring="motion_modules.")``."""
    out = dict(base)
    for k, v in overlay.items():
        if filter_substring is None or filter_substring in k:
            out[k] = v
    return out


def check_state_dict(sd: Mapping[str, torch.Tensor], module: torch.nn.Module,
                     what: str = "checkpoint") -> None:
    """Raise ``ValueError`` unless ``sd`` has exactly ``module``'s keys, each
    at the module's shape.  ``module`` may live on the meta device."""
    want = module.state_dict()
    unexpected = sorted(set(sd) - set(want))
    if unexpected:
        raise ValueError(f"{what}: {len(unexpected)} unexpected keys, e.g. {unexpected[:5]}")
    mismatched = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in want.items()
                  if k in sd and tuple(sd[k].shape) != tuple(v.shape)]
    if mismatched:
        raise ValueError(f"{what}: {len(mismatched)} shape mismatches "
                         f"(key, loaded, module), e.g. {mismatched[:5]}")
    missing = sorted(set(want) - set(sd))
    if missing:
        raise ValueError(f"{what}: {len(missing)} module parameters not covered, "
                         f"e.g. {missing[:5]}")
