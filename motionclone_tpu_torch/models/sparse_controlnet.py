"""SparseControlNet: sparse-frame image conditioning (AnimateDiff SparseCtrl).

Port of ``motionclone_tpu/models/sparse_controlnet.py``.  The model is the
UNet3D's down and mid half, with:

* a conditioning embedding: a single zero-initialised 3x3 conv over a
  latent-space condition ("simplified", the RGB workload,
  configs/sparsectrl/latent_condition.yaml), or a strided conv stack over a
  pixel-space condition (the scribble workload, image_condition.yaml);
* a one-channel conditioning mask concatenated to the condition: the
  caller scatters the condition frames into zeros and sets the mask at
  their frame indices (:func:`scatter_condition`);
* ``set_noisy_sample_input_to_zero``: the latent input is replaced by
  conv_in applied to zeros, that is conv_in's bias broadcast (exactly);
* 1x1 zero-conv heads per skip (``controlnet_down_blocks.N``) and for the
  mid block (``controlnet_mid_block``), scaled by ``conditioning_scale``;
* its own motion modules with one temporal attention block and a
  positional-encoding table of 32 rows.

Submodule names are the SparseCtrl checkpoint's keys, so a ``.ckpt`` loads
strictly (``weights/load.controlnet_state_dict``).  ``impl`` ("flash" or
"fused") routes every resnet, spatial transformer and motion module as in
the UNet: the fused kernels 5, 7 (one attention block) and 8 where their
predicates take the shapes.

With a ``frame_group`` (``parallel/frames.py``; the JAX package's
``frames_axis``) the sample, the condition and its mask hold the rank's
frames, as the UNet's do: everything runs per frame on them but the
motion modules, which gather their keys and values over the group and
attend with the local queries (kernel 3r, positional-encoding rows from
rank * f of the 32-row table; kernel 7 is off).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from motionclone_tpu_torch.config import MotionModuleConfig, UNet3DConfig
from motionclone_tpu_torch.models.embeddings import TimestepEmbedding, timestep_embedding
from motionclone_tpu_torch.models.layers import conv2d, spatial_conv
from motionclone_tpu_torch.models.unet_blocks import (
    CrossAttnDownBlock3D,
    DownBlock3D,
    UNetMidBlock3DCrossAttn,
)
from motionclone_tpu_torch.parallel.frames import FrameGroup


@dataclasses.dataclass(frozen=True)
class SparseControlNetConfig:
    in_channels: int = 4
    conditioning_channels: int = 3
    concate_conditioning_mask: bool = True
    use_simplified_condition_embedding: bool = False
    set_noisy_sample_input_to_zero: bool = False
    conditioning_embedding_out_channels: Tuple[int, ...] = (16, 32, 96, 256)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "DownBlock3D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 768
    num_heads: int = 8
    use_motion_module: bool = True
    motion_module_resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    motion_module_mid_block: bool = False
    motion_module: MotionModuleConfig = MotionModuleConfig(
        attention_block_types=("Temporal_Self",),
        temporal_position_encoding_max_len=32,
    )

    @classmethod
    def from_yaml_dict(cls, d: Mapping[str, Any],
                       unet_cfg: Optional[UNet3DConfig] = None) -> "SparseControlNetConfig":
        """Build from a sparsectrl YAML's ``controlnet_additional_kwargs`` on
        top of the base UNet's topology (the reference's ``from_unet``)."""
        kwargs: dict = {}
        if unet_cfg is not None:
            kwargs.update(
                block_out_channels=unet_cfg.block_out_channels,
                layers_per_block=unet_cfg.layers_per_block,
                norm_num_groups=unet_cfg.norm_num_groups,
                norm_eps=unet_cfg.norm_eps,
                cross_attention_dim=unet_cfg.cross_attention_dim,
                num_heads=unet_cfg.num_heads,
                in_channels=unet_cfg.in_channels,
            )
        for key in ("conditioning_channels", "concate_conditioning_mask",
                    "use_simplified_condition_embedding", "set_noisy_sample_input_to_zero",
                    "use_motion_module", "motion_module_mid_block"):
            if key in d:
                kwargs[key] = d[key]
        if "motion_module_resolutions" in d:
            kwargs["motion_module_resolutions"] = tuple(d["motion_module_resolutions"])
        if "motion_module_kwargs" in d:
            kwargs["motion_module"] = MotionModuleConfig.from_dict(d["motion_module_kwargs"])
        return cls(**kwargs)

    @property
    def condition_downscale(self) -> int:
        """Pixels of the condition per latent pixel: 1 for the simplified
        (latent-space) embedding, else the conv stack's 2**(stages - 1)."""
        if self.use_simplified_condition_embedding:
            return 1
        return 2 ** (len(self.conditioning_embedding_out_channels) - 1)


class ConditioningEmbedding(nn.Module):
    """Strided conv stack: pixel-space condition -> latent-resolution
    features (SiLU after every conv but the zero-initialised conv_out)."""

    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int]):
        super().__init__()
        boc = tuple(block_out_channels)
        self.conv_in = conv2d(in_channels, boc[0])
        blocks = []
        for i in range(len(boc) - 1):
            blocks += [conv2d(boc[i], boc[i]), conv2d(boc[i], boc[i + 1], stride=2)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = conv2d(boc[-1], out_channels)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(spatial_conv(cond, self.conv_in))
        for conv in self.blocks:
            x = F.silu(spatial_conv(x, conv))
        return spatial_conv(x, self.conv_out)


def _zero_conv(in_ch: int, out_ch: int, kernel: int) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


def _pointwise(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    # a 1x1 conv on channels-last data is a dense layer on the last axis
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class SparseControlNetModel(nn.Module):
    def __init__(self, cfg: SparseControlNetConfig):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        mm = cfg.motion_module
        self.time_embedding = TimestepEmbedding(ch0, temb_ch)
        self.conv_in = conv2d(cfg.in_channels, ch0)
        cond_ch = cfg.conditioning_channels + int(cfg.concate_conditioning_mask)
        if cfg.use_simplified_condition_embedding:
            self.controlnet_cond_embedding = _zero_conv(cond_ch, ch0, 3)
        else:
            self.controlnet_cond_embedding = ConditioningEmbedding(
                cond_ch, ch0, cfg.conditioning_embedding_out_channels)

        skip_ch = [ch0]
        ch = ch0
        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            common = dict(
                in_channels=ch, out_channels=out_ch, temb_channels=temb_ch,
                num_layers=cfg.layers_per_block,
                norm_num_groups=cfg.norm_num_groups, norm_eps=cfg.norm_eps,
                add_downsample=i < len(cfg.block_out_channels) - 1,
                use_inflated_groupnorm=True,  # hard-coded in the reference
                use_motion_module=cfg.use_motion_module
                and 2**i in cfg.motion_module_resolutions,
                motion_module_cfg=mm, path=f"down_blocks.{i}",
            )
            if block_type == "CrossAttnDownBlock3D":
                block = CrossAttnDownBlock3D(heads=cfg.num_heads,
                                             cross_attention_dim=cfg.cross_attention_dim,
                                             **common)
            elif block_type == "DownBlock3D":
                block = DownBlock3D(**common)
            else:
                raise ValueError(f"unknown down block type: {block_type}")
            self.down_blocks.append(block)
            ch = out_ch
            skip_ch += [out_ch] * (cfg.layers_per_block + common["add_downsample"])

        self.mid_block = UNetMidBlock3DCrossAttn(
            channels=cfg.block_out_channels[-1], temb_channels=temb_ch, num_layers=1,
            heads=cfg.num_heads, cross_attention_dim=cfg.cross_attention_dim,
            norm_num_groups=cfg.norm_num_groups, norm_eps=cfg.norm_eps,
            use_inflated_groupnorm=True,
            use_motion_module=cfg.use_motion_module and cfg.motion_module_mid_block,
            motion_module_cfg=mm,
        )
        self.controlnet_down_blocks = nn.ModuleList([_zero_conv(c, c, 1) for c in skip_ch])
        self.controlnet_mid_block = _zero_conv(ch, ch, 1)

    def forward(
        self,
        sample: torch.Tensor,  # (B, F, h, w, 4) noisy latents
        timestep,  # int or 0-d / (B,) tensor
        encoder_hidden_states: torch.Tensor,  # (B or 1, L, cross_attention_dim)
        controlnet_cond: torch.Tensor,  # (B, F, H', W', conditioning_channels)
        conditioning_mask: Optional[torch.Tensor] = None,  # (B, F, H', W', 1)
        conditioning_scale=1.0,  # a float, or (B, 1, 1, 1, 1): one per example
        impl: str = "flash",
        frame_group: Optional[FrameGroup] = None,
    ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        """Returns (down residuals, one per UNet skip; mid residual)."""
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        if impl not in ("flash", "fused"):
            raise ValueError(f"unknown attention impl {impl!r} (flash or fused)")
        sample = sample.to(dtype)
        b = sample.shape[0]
        context = encoder_hidden_states.to(dtype)
        if context.shape[0] != b:
            context = context.repeat_interleave(b // context.shape[0], dim=0)

        t = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(b)
        temb = self.time_embedding(timestep_embedding(t, cfg.block_out_channels[0]).to(dtype))

        if cfg.set_noisy_sample_input_to_zero:
            # conv_in of zeros is its bias at every pixel
            x = self.conv_in.bias.to(dtype).expand(*sample.shape[:-1], -1)
        else:
            x = spatial_conv(sample, self.conv_in)

        cond = controlnet_cond.to(dtype)
        if cfg.concate_conditioning_mask:
            if conditioning_mask is None:
                raise ValueError("this controlnet concatenates a conditioning mask; "
                                 "pass conditioning_mask")
            cond = torch.cat([cond, conditioning_mask.to(dtype)], dim=-1)
        emb = self.controlnet_cond_embedding
        x = x + (spatial_conv(cond, emb) if isinstance(emb, nn.Conv2d) else emb(cond))

        skips = [x]
        for block in self.down_blocks:
            if isinstance(block, CrossAttnDownBlock3D):
                x, block_skips, _ = block(x, temb, context, (), impl, frame_group)
            else:
                x, block_skips, _ = block(x, temb, (), impl, frame_group)
            skips.extend(block_skips)
        x, _ = self.mid_block(x, temb, context, (), impl, frame_group)

        down = tuple(_pointwise(s, head) * conditioning_scale
                     for s, head in zip(skips, self.controlnet_down_blocks))
        return down, _pointwise(x, self.controlnet_mid_block) * conditioning_scale


def scatter_condition(
    condition_frames: torch.Tensor,  # (B, N, H, W, C) condition images or latents
    image_index: Sequence[int],
    video_length: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeros with the N condition frames set at ``image_index``, and the
    one-channel mask that is 1 at those frames."""
    b, n, h, w, c = condition_frames.shape
    if n != len(image_index):
        raise ValueError(f"{n} condition frames for {len(image_index)} image_index entries")
    kw = dict(dtype=condition_frames.dtype, device=condition_frames.device)
    cond = torch.zeros((b, video_length, h, w, c), **kw)
    mask = torch.zeros((b, video_length, h, w, 1), **kw)
    idx = torch.as_tensor(list(image_index), dtype=torch.long, device=condition_frames.device)
    cond[:, idx] = condition_frames
    mask[:, idx] = 1.0
    return cond, mask
