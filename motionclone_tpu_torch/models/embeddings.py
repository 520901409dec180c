"""Timestep and temporal-position embeddings.

Port of ``motionclone_tpu/models/embeddings.py``: diffusers'
``get_timestep_embedding`` / ``TimestepEmbedding`` and the motion module's
fixed sinusoidal positional table; and SDXL's embedding of its size and
crop ids (diffusers' ``add_time_proj``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep features, float32, shape (batch, dim)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    freqs = torch.exp(exponent / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over sinusoidal features (diffusers ``TimestepEmbedding``)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


def time_ids_embedding(time_ids: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0) -> torch.Tensor:
    """SDXL's size and crop ids (B, n) -> (B, n * dim) float32: each id
    through the ``dim``-wide sinusoid of the timestep embedding."""
    b = time_ids.shape[0]
    return timestep_embedding(time_ids.reshape(-1), dim, flip_sin_to_cos,
                              freq_shift).reshape(b, -1)


def temporal_positional_encoding(d_model: int, max_len: int) -> np.ndarray:
    """The motion module's fixed table, float32 (max_len, d_model):
    pe[:, 0::2] = sin, pe[:, 1::2] = cos.  Not a parameter: checkpoint
    loaders skip ``pos_encoder.pe`` keys."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)
