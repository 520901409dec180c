"""UNet3D down/mid/up blocks.

Port of ``motionclone_tpu/models/unet_blocks.py``.  Layer order per block
layer:

* down (cross-attn):  resnet -> spatial transformer -> motion module
* down (plain):       resnet -> motion module
* mid:                resnet0, then [attn -> motion -> resnet] x N
* up (cross-attn):    concat skip -> resnet -> attn -> motion
* up (plain):         concat skip -> resnet -> motion

Each block returns a dict of temporal-attention probability maps of the
motion modules whose dotted path contains a ``guidance_blocks`` substring.
``impl`` ("flash" or "fused") is handed to every resnet, spatial
transformer and motion module of the block, and ``frame_group`` (frame
sharding, ``parallel/frames.py``) to every motion module.  A spatial
transformer holds ``transformer_layers`` layers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from motionclone_tpu_torch.config import MotionModuleConfig
from motionclone_tpu_torch.models.attention import Transformer3DModel
from motionclone_tpu_torch.models.layers import Downsample, Upsample
from motionclone_tpu_torch.models.motion_module import VanillaTemporalModule
from motionclone_tpu_torch.models.resnet import ResnetBlock3D
from motionclone_tpu_torch.parallel.frames import FrameGroup

ProbsDict = Dict[str, torch.Tensor]


def match_guidance(path: str, guidance_blocks: Tuple[str, ...]) -> bool:
    """Substring matching (the reference's ``classify_blocks``)."""
    return any(g in path for g in guidance_blocks)


def probs_keys(mm_path: str, cfg: MotionModuleConfig) -> Tuple[str, ...]:
    """VersatileAttention module names in TemporalTransformer3D's emission
    order (transformer block major, attention block minor)."""
    return tuple(
        f"{mm_path}.temporal_transformer.transformer_blocks.{i}.attention_blocks.{k}"
        for i in range(cfg.num_transformer_block)
        for k in range(len(cfg.attention_block_types))
    )


class _Block(nn.Module):
    """Shared construction and motion-module plumbing of the five blocks."""

    def __init__(self, path: str, mm_cfg: Optional[MotionModuleConfig]):
        super().__init__()
        self.path = path
        self.mm_cfg = mm_cfg

    def _motion(self, x: torch.Tensor, idx: int, guidance_blocks: Tuple[str, ...],
                probs: ProbsDict, impl: str,
                frame_group: Optional[FrameGroup]) -> torch.Tensor:
        if self.motion_modules is None:
            return x
        mm_path = f"{self.path}.motion_modules.{idx}"
        collect = match_guidance(mm_path, guidance_blocks)
        x, p = self.motion_modules[idx](x, return_probs=collect, impl=impl,
                                        frame_group=frame_group)
        if collect:
            probs.update(zip(probs_keys(mm_path, self.mm_cfg), p))
        return x


def _resnet(in_ch, out_ch, temb_ch, groups, eps, inflated):
    return ResnetBlock3D(in_ch, out_ch, temb_ch, groups=groups, eps=eps,
                         use_inflated_groupnorm=inflated)


def _transformer(ch, heads, cross_dim, groups, linear, layers):
    return Transformer3DModel(ch, heads, ch // heads,
                              cross_attention_dim=cross_dim,
                              norm_num_groups=groups,
                              use_linear_projection=linear, num_layers=layers)


def _motion_modules(ch, n, use, cfg):
    if not use:
        return None
    return nn.ModuleList([VanillaTemporalModule(ch, cfg) for _ in range(n)])


class CrossAttnDownBlock3D(_Block):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int, heads: int, cross_attention_dim: int,
                 norm_num_groups: int, norm_eps: float, add_downsample: bool,
                 use_inflated_groupnorm: bool, use_motion_module: bool,
                 motion_module_cfg: Optional[MotionModuleConfig],
                 use_linear_projection: bool = False, path: str = "",
                 transformer_layers: int = 1):
        super().__init__(path, motion_module_cfg)
        self.resnets = nn.ModuleList([
            _resnet(in_channels if i == 0 else out_channels, out_channels,
                    temb_channels, norm_num_groups, norm_eps, use_inflated_groupnorm)
            for i in range(num_layers)
        ])
        self.attentions = nn.ModuleList([
            _transformer(out_channels, heads, cross_attention_dim, norm_num_groups,
                         use_linear_projection, transformer_layers)
            for _ in range(num_layers)
        ])
        self.motion_modules = _motion_modules(
            out_channels, num_layers, use_motion_module, motion_module_cfg)
        self.downsamplers = (
            nn.ModuleList([Downsample(out_channels)])
            if add_downsample else None
        )

    def forward(self, x, temb, context, guidance_blocks=(), impl="flash",
                frame_group=None):
        skips: List[torch.Tensor] = []
        probs: ProbsDict = {}
        for i, (resnet, attn) in enumerate(zip(self.resnets, self.attentions)):
            x = attn(resnet(x, temb, impl), context, impl)
            x = self._motion(x, i, guidance_blocks, probs, impl, frame_group)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, tuple(skips), probs


class DownBlock3D(_Block):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int, norm_num_groups: int, norm_eps: float,
                 add_downsample: bool, use_inflated_groupnorm: bool,
                 use_motion_module: bool,
                 motion_module_cfg: Optional[MotionModuleConfig], path: str = ""):
        super().__init__(path, motion_module_cfg)
        self.resnets = nn.ModuleList([
            _resnet(in_channels if i == 0 else out_channels, out_channels,
                    temb_channels, norm_num_groups, norm_eps, use_inflated_groupnorm)
            for i in range(num_layers)
        ])
        self.motion_modules = _motion_modules(
            out_channels, num_layers, use_motion_module, motion_module_cfg)
        self.downsamplers = (
            nn.ModuleList([Downsample(out_channels)])
            if add_downsample else None
        )

    def forward(self, x, temb, guidance_blocks=(), impl="flash", frame_group=None):
        skips: List[torch.Tensor] = []
        probs: ProbsDict = {}
        for i, resnet in enumerate(self.resnets):
            x = self._motion(resnet(x, temb, impl), i, guidance_blocks, probs, impl,
                             frame_group)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, tuple(skips), probs


class UNetMidBlock3DCrossAttn(_Block):
    def __init__(self, channels: int, temb_channels: int, num_layers: int,
                 heads: int, cross_attention_dim: int, norm_num_groups: int,
                 norm_eps: float, use_inflated_groupnorm: bool,
                 use_motion_module: bool,
                 motion_module_cfg: Optional[MotionModuleConfig],
                 use_linear_projection: bool = False, path: str = "mid_block",
                 transformer_layers: int = 1):
        super().__init__(path, motion_module_cfg)
        self.resnets = nn.ModuleList([
            _resnet(channels, channels, temb_channels, norm_num_groups, norm_eps,
                    use_inflated_groupnorm)
            for _ in range(num_layers + 1)
        ])
        self.attentions = nn.ModuleList([
            _transformer(channels, heads, cross_attention_dim, norm_num_groups,
                         use_linear_projection, transformer_layers)
            for _ in range(num_layers)
        ])
        self.motion_modules = _motion_modules(
            channels, num_layers, use_motion_module, motion_module_cfg)

    def forward(self, x, temb, context, guidance_blocks=(), impl="flash",
                frame_group=None):
        probs: ProbsDict = {}
        x = self.resnets[0](x, temb, impl)
        for i, attn in enumerate(self.attentions):
            x = self._motion(attn(x, context, impl), i, guidance_blocks, probs, impl,
                             frame_group)
            x = self.resnets[i + 1](x, temb, impl)
        return x, probs


class CrossAttnUpBlock3D(_Block):
    def __init__(self, in_channels: List[int], out_channels: int,
                 temb_channels: int, num_layers: int, heads: int,
                 cross_attention_dim: int, norm_num_groups: int,
                 norm_eps: float, add_upsample: bool,
                 use_inflated_groupnorm: bool, use_motion_module: bool,
                 motion_module_cfg: Optional[MotionModuleConfig],
                 use_linear_projection: bool = False, path: str = "",
                 transformer_layers: int = 1):
        """``in_channels``: each resnet's input width (activation + skip)."""
        super().__init__(path, motion_module_cfg)
        self.resnets = nn.ModuleList([
            _resnet(c, out_channels, temb_channels, norm_num_groups, norm_eps,
                    use_inflated_groupnorm)
            for c in in_channels
        ])
        self.attentions = nn.ModuleList([
            _transformer(out_channels, heads, cross_attention_dim, norm_num_groups,
                         use_linear_projection, transformer_layers)
            for _ in range(num_layers)
        ])
        self.motion_modules = _motion_modules(
            out_channels, num_layers, use_motion_module, motion_module_cfg)
        self.upsamplers = (
            nn.ModuleList([Upsample(out_channels)])
            if add_upsample else None
        )

    def forward(self, x, skips, temb, context, guidance_blocks=(), impl="flash",
                frame_group=None):
        probs: ProbsDict = {}
        skips = list(skips)
        for i, (resnet, attn) in enumerate(zip(self.resnets, self.attentions)):
            x = resnet(torch.cat([x, skips.pop()], dim=-1), temb, impl)
            x = self._motion(attn(x, context, impl), i, guidance_blocks, probs, impl,
                             frame_group)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x, probs


class UpBlock3D(_Block):
    def __init__(self, in_channels: List[int], out_channels: int,
                 temb_channels: int, num_layers: int, norm_num_groups: int,
                 norm_eps: float, add_upsample: bool,
                 use_inflated_groupnorm: bool, use_motion_module: bool,
                 motion_module_cfg: Optional[MotionModuleConfig], path: str = ""):
        """``in_channels``: each resnet's input width (activation + skip)."""
        super().__init__(path, motion_module_cfg)
        self.resnets = nn.ModuleList([
            _resnet(c, out_channels, temb_channels, norm_num_groups, norm_eps,
                    use_inflated_groupnorm)
            for c in in_channels
        ])
        self.motion_modules = _motion_modules(
            out_channels, num_layers, use_motion_module, motion_module_cfg)
        self.upsamplers = (
            nn.ModuleList([Upsample(out_channels)])
            if add_upsample else None
        )

    def forward(self, x, skips, temb, guidance_blocks=(), impl="flash",
                frame_group=None):
        probs: ProbsDict = {}
        skips = list(skips)
        for i, resnet in enumerate(self.resnets):
            x = self._motion(resnet(torch.cat([x, skips.pop()], dim=-1), temb, impl),
                             i, guidance_blocks, probs, impl, frame_group)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x, probs
