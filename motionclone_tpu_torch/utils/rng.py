"""Domain-separated noise draws for the per-example seed.

The runtime passes one seed to every noise consumer of an example.  A
generator seeded with the bare seed would make the VAE posterior draw, the
extraction's add-noise draw and the initial sampling latents (all shaped
(1, F, h, w, 4)) the same tensor.  So each consumer names a domain, and the
generator is seeded with a mix of (seed, domain):
``numpy.random.SeedSequence([seed, domain]).generate_state(1, numpy.uint64)``,
a fixed function of the pair.  The domain tags are those of
``motionclone_tpu/utils/rng.py``.  The streams themselves differ from JAX's
by design; parity tests substitute JAX's draw for :func:`draw_normal`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

VAE_POSTERIOR = 1       # reference-video VAE encode posterior draw
EXTRACT_NOISE = 2       # add_noise eps during motion-rep extraction
INIT_LATENTS = 3        # initial sampling latents
CN_IMAGE_POSTERIOR = 4  # condition-image VAE posterior draw (i2v)


def draw_normal(shape: Sequence[int], seed: int, domain: int, device) -> torch.Tensor:
    """Standard normal float32 noise of ``shape`` on ``device``, drawn from a
    generator on that device seeded with the 64-bit mix of ``(seed,
    domain)``."""
    mixed = np.random.SeedSequence([seed, domain]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(mixed))
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
