"""Seeded weights for a configuration, made on the device in a few large
draws, in the type they are served in.

``chip_smoke.py``'s ``init_scaled_`` rule, which keeps activations O(1)
through the depth: fan-in-scaled normal matrices and kernels, embeddings
N(0, 0.5), norm scales N(1, 0.1), other vectors N(0, 0.1); no projection
is zero.  The leaves are the plain reference's parameters in its order
(the model family's ``networks``, whose names are the program's
state-dict keys).  One standard normal draw per network fills every leaf
of it, which is then scaled and shifted in place, so the same seed on the
same device gives the same weights bit for bit: the program's copy before
the window, the reference's after it.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

SEED_DOMAIN = 100


def _leaves(module: nn.Module) -> Iterator[Tuple[str, torch.Size, float, float]]:
    """(name, shape, mean, std) of each parameter."""
    for mod_name, mod in module.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(mod, nn.Embedding):
                yield name, p.shape, 0.0, 0.5
            elif p.dim() >= 2:
                yield name, p.shape, 0.0, p[0].numel() ** -0.5
            elif p_name == "weight":
                yield name, p.shape, 1.0, 0.1
            else:
                yield name, p.shape, 0.0, 0.1


def make(networks: Mapping[str, nn.Module], seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{network: {parameter name: tensor}} for the reference ``networks``
    (on any device: only their parameters' names and shapes are read); the
    i-th network by name gets the i-th draw."""
    out = {}
    for i, (key, module) in enumerate(sorted(networks.items())):
        leaves = list(_leaves(module))
        total = sum(int(np.prod(shape)) for _, shape, _, _ in leaves)
        mixed = np.random.SeedSequence([seed, SEED_DOMAIN, i]).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=device).manual_seed(int(mixed))
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        tensors, offset = {}, 0
        for name, shape, mean, std in leaves:
            n = int(np.prod(shape))
            tensors[name] = flat[offset:offset + n].view(shape).mul_(std).add_(mean)
            offset += n
        out[key] = tensors
    return out


def load(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> None:
    """Copy ``tensors`` into ``module``'s parameters, which must be exactly
    those names and shapes."""
    params = dict(module.named_parameters())
    if set(params) != set(tensors):
        raise ValueError(f"{type(module).__name__}: parameters differ from the reference's: "
                         f"{sorted(set(params) ^ set(tensors))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != tensors[name].shape:
                raise ValueError(f"{name}: shape {tuple(p.shape)}, the reference's "
                                 f"{tuple(tensors[name].shape)}")
            p.copy_(tensors[name])
