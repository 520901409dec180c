"""ResnetBlock3D: the UNet's conv backbone block.

Port of ``motionclone_tpu/models/resnet.py``.  Submodule names follow the
diffusers keys: ``norm1``, ``conv1``, ``time_emb_proj``, ``norm2``,
``conv2``, ``conv_shortcut``.

With ``impl="fused"`` a block that the JAX package fuses (same predicate,
``ops/fused_resnet.supported``) and, on CUDA, whose shapes kernel 8 takes
(``ops/fused_resnet.device_supported``: :meth:`ResnetBlock3D.fused_route`)
runs as kernel 8, forward only, on its weights repacked once into the
kernel's layout and cached on the module; any other block, and
``impl="flash"``, runs the unfused path.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from motionclone_tpu_torch.models.layers import GroupNorm, conv2d, spatial_conv
from motionclone_tpu_torch.ops import fused_resnet
from motionclone_tpu_torch.ops.fused_common import cached_pack, takes_kernel


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

    def fused_weights(self, dtype: torch.dtype) -> fused_resnet.ResnetWeights:
        """The block's weights in kernel 8's layout, matrices in ``dtype``."""
        def build():
            sc = self.conv_shortcut
            return fused_resnet.ResnetWeights(
                self.norm1.weight.float(), self.norm1.bias.float(),
                fused_resnet.conv_weight(self.conv1.weight).to(dtype),
                self.conv1.bias.float(),
                self.norm2.weight.float(), self.norm2.bias.float(),
                fused_resnet.conv_weight(self.conv2.weight).to(dtype),
                self.conv2.bias.float(),
                None if sc is None else sc.weight[:, :, 0, 0].to(dtype).contiguous(),
                None if sc is None else sc.bias.float(),
            )
        return cached_pack(self, dtype, build)

    def fused_route(self, x_shape, device_type: str, itemsize: int = 2) -> bool:
        """Whether ``impl="fused"`` runs kernel 8 for a (B, F, H, W, Cin)
        input of ``itemsize``-byte elements on ``device_type``, from the
        shapes alone."""
        cout = self.conv1.out_channels
        return self.per_frame and takes_kernel(
            device_type,
            fused_resnet.supported(x_shape, cout, self.norm1.num_groups, itemsize=itemsize),
            lambda: fused_resnet.device_supported(x_shape, cout))

    def forward(self, x: torch.Tensor, temb: torch.Tensor, impl: str = "flash") -> torch.Tensor:
        if impl == "fused" and self.fused_route(x.shape, x.device.type, x.element_size()):
            t = self.time_emb_proj(F.silu(temb))
            return fused_resnet.fused_resnet_block(
                x, t, self.fused_weights(x.dtype), groups=self.norm1.num_groups,
                eps=self.norm1.eps,
            )
        h = spatial_conv(self.norm1(x, per_frame=self.per_frame, silu=True), self.conv1)
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = self.norm2(h, per_frame=self.per_frame, silu=True)
        h = spatial_conv(h, self.conv2)
        if self.conv_shortcut is not None:
            # a 1x1 conv on channels-last data is a dense layer on the last axis
            x = F.linear(x, self.conv_shortcut.weight[:, :, 0, 0], self.conv_shortcut.bias)
        return x + h
