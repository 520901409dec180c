"""ResnetBlock3D: the UNet's conv backbone block.

Port of ``motionclone_tpu/models/resnet.py`` (the unfused path).  Submodule
names follow the diffusers keys: ``norm1``, ``conv1``, ``time_emb_proj``,
``norm2``, ``conv2``, ``conv_shortcut``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from motionclone_tpu_torch.models.layers import GroupNorm, conv2d, spatial_conv


class ResnetBlock3D(nn.Module):
    """GN+SiLU -> conv3x3, + projected time embedding, GN+SiLU -> conv3x3,
    + the input (through a 1x1 conv when the width changes)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 groups: int = 32, eps: float = 1e-5,
                 use_inflated_groupnorm: bool = True):
        super().__init__()
        self.per_frame = use_inflated_groupnorm
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = conv2d(in_channels, out_channels)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = conv2d(out_channels, out_channels)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = spatial_conv(F.silu(self.norm1(x, per_frame=self.per_frame)), self.conv1)
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = F.silu(self.norm2(h, per_frame=self.per_frame))
        h = spatial_conv(h, self.conv2)
        if self.conv_shortcut is not None:
            # a 1x1 conv on channels-last data is a dense layer on the last axis
            x = F.linear(x, self.conv_shortcut.weight[:, :, 0, 0], self.conv_shortcut.bias)
        return x + h
