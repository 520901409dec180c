"""The control: the plain reference computed one precision below the
configurations' bf16, that is in fp8 (e4m3), the step that would tempt a
later change.  Every matrix product's operands (the input of each
``nn.Linear`` and ``nn.Conv2d``, per tensor, and its weight, per output
row) and every tensor that the program keeps between stages (text
embeddings, latents, the motion representation's values, the sampling
state) are rounded to fp8 with a scale that maps their largest magnitude
to fp8's largest value; the arithmetic between them stays f32.  Gradients
pass the rounding straight through."""

from __future__ import annotations

import torch
from torch import nn

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x`` rounded to fp8 values (scaled by its absolute maximum, over
    ``dim`` or the whole tensor), in x's dtype."""
    amax = x.detach().abs().amax() if dim is None else x.detach().abs().amax(dim, keepdim=True)
    scale = amax.clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(FP8).to(x.dtype) * scale
    return x + (q - x).detach()


def to_fp8(module: nn.Module) -> nn.Module:
    """Round ``module``'s product weights in place and the inputs of its
    products on every call."""
    def round_input(_, args):
        return (fp8_round(args[0]),) + tuple(args[1:])

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.copy_(fp8_round(m.weight, dim=tuple(range(1, m.weight.dim()))))
                m.register_forward_pre_hook(round_input)
    return module
