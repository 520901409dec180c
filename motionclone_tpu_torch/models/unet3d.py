"""UNet3DConditionModel: the AnimateDiff UNet (SD1.5's, or SDXL's).

Port of ``motionclone_tpu/models/unet3d.py``, grown to SDXL's topology
(``config.UNet3DConfig``: the levels read from ``block_out_channels``,
per-level heads and transformer depths, motion modules placed by level,
the ``text_time`` added embedding as ``add_embedding``).  Submodule names
follow the diffusers keys.  Activations are
channels-last video tensors (B, F, H, W, C); latents are (B, F, 64, 64, 4)
at 512x512.

* ``added_cond``: SDXL's (pooled text (B, 1280), size and crop ids (B,
  6)), embedded and added to the time embedding; required by, and only
  taken by, a model with the added embedding.
* ``cfg.guided_recompute``: the differentiated pass recomputes each
  transformer layer's activations in its backward (set on the transformers
  at construction; no effect without autograd).

* ``guidance_blocks``: the temporal-attention probabilities of matching
  motion modules come back as an explicit dict (no recorder hooks), so the
  motion representation and the guidance loss are functions of the inputs.
* ``max_up_block``: run up blocks ``0..max_up_block`` only and return no
  noise prediction (the extraction early exit).
* ``post_guidance_cut``: up blocks after this index run under
  ``torch.no_grad()`` on detached inputs.  The guidance loss reads only
  probabilities emitted at or before the cut, so this changes no value and
  no gradient; it keeps autograd from storing the tail's activations (the
  reference's no-grad split after the last guidance block).
* ``down_block_residuals`` / ``mid_block_residual``: a controlnet's
  residuals (``models/sparse_controlnet.py``), added to the skips after the
  down blocks and to the mid block's output, cast to the activation dtype.
* ``frame_group``: frame-sharded sampling (``parallel/frames.py``): the
  sample holds the rank's frames and every motion module gathers its keys
  and values over the group; everything else works per frame.
* ``attention_impl``: "flash" (the unfused path: flash and temporal
  attention kernels) or "fused" (resnets, spatial transformers and motion
  modules that the JAX package fuses run as kernels 5-8, forward only);
  ``post_guidance_impl`` overrides it for the up blocks past the cut, as the
  JAX package runs them fused in the differentiated pass.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from motionclone_tpu_torch.config import UNet3DConfig
from motionclone_tpu_torch.models.embeddings import (
    TimestepEmbedding,
    time_ids_embedding,
    timestep_embedding,
)
from motionclone_tpu_torch.models.layers import GroupNorm, conv2d, spatial_conv
from motionclone_tpu_torch.models.unet_blocks import (
    CrossAttnDownBlock3D,
    CrossAttnUpBlock3D,
    DownBlock3D,
    UNetMidBlock3DCrossAttn,
    UpBlock3D,
)
from motionclone_tpu_torch.parallel.frames import FrameGroup

ProbsDict = Dict[str, torch.Tensor]


class UNet3DConditionModel(nn.Module):
    def __init__(self, cfg: UNet3DConfig):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        mm = cfg.motion_module
        self.time_embedding = TimestepEmbedding(ch0, temb_ch)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                                   temb_ch)
        self.conv_in = conv2d(cfg.in_channels, ch0)
        levels = cfg.levels

        skip_ch = [ch0]
        ch = ch0
        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            use_mm = (
                cfg.use_motion_module
                and 2**i in cfg.motion_module_resolutions
                and not cfg.motion_module_decoder_only
            )
            common = dict(
                in_channels=ch, out_channels=out_ch, temb_channels=temb_ch,
                num_layers=cfg.layers_per_block,
                norm_num_groups=cfg.norm_num_groups, norm_eps=cfg.norm_eps,
                add_downsample=i < len(cfg.block_out_channels) - 1,
                use_inflated_groupnorm=cfg.use_inflated_groupnorm,
                use_motion_module=use_mm, motion_module_cfg=mm,
                path=f"down_blocks.{i}",
            )
            if block_type == "CrossAttnDownBlock3D":
                block = CrossAttnDownBlock3D(
                    heads=cfg.heads(i), cross_attention_dim=cfg.cross_attention_dim,
                    use_linear_projection=cfg.use_linear_projection,
                    transformer_layers=cfg.depth(i), **common)
            elif block_type == "DownBlock3D":
                block = DownBlock3D(**common)
            else:
                raise ValueError(f"unknown down block type: {block_type}")
            self.down_blocks.append(block)
            ch = out_ch
            skip_ch += [out_ch] * (cfg.layers_per_block + common["add_downsample"])

        self.mid_block = UNetMidBlock3DCrossAttn(
            channels=cfg.block_out_channels[-1], temb_channels=temb_ch,
            num_layers=1, heads=cfg.heads(-1),
            cross_attention_dim=cfg.cross_attention_dim,
            norm_num_groups=cfg.norm_num_groups, norm_eps=cfg.norm_eps,
            use_inflated_groupnorm=cfg.use_inflated_groupnorm,
            use_motion_module=cfg.use_motion_module and cfg.motion_module_mid_block,
            motion_module_cfg=mm,
            use_linear_projection=cfg.use_linear_projection,
            transformer_layers=cfg.depth(-1),
        )

        reversed_ch = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.up_block_types):
            out_ch = reversed_ch[i]
            num_layers = cfg.layers_per_block + 1
            in_chs = []
            for _ in range(num_layers):
                in_chs.append(ch + skip_ch.pop())
                ch = out_ch
            common = dict(
                in_channels=in_chs, out_channels=out_ch, temb_channels=temb_ch,
                num_layers=num_layers,
                norm_num_groups=cfg.norm_num_groups, norm_eps=cfg.norm_eps,
                add_upsample=i < len(cfg.up_block_types) - 1,
                use_inflated_groupnorm=cfg.use_inflated_groupnorm,
                use_motion_module=(
                    cfg.use_motion_module
                    and 2 ** (levels - 1 - i) in cfg.motion_module_resolutions
                ),
                motion_module_cfg=mm, path=f"up_blocks.{i}",
            )
            if block_type == "CrossAttnUpBlock3D":
                level = levels - 1 - i
                block = CrossAttnUpBlock3D(
                    heads=cfg.heads(level), cross_attention_dim=cfg.cross_attention_dim,
                    use_linear_projection=cfg.use_linear_projection,
                    transformer_layers=cfg.depth(level), **common)
            elif block_type == "UpBlock3D":
                block = UpBlock3D(**common)
            else:
                raise ValueError(f"unknown up block type: {block_type}")
            self.up_blocks.append(block)

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch0, eps=cfg.norm_eps)
        self.conv_out = conv2d(ch0, cfg.out_channels)
        for block in (*self.down_blocks, self.mid_block, *self.up_blocks):
            for attn in getattr(block, "attentions", None) or ():
                attn.recompute = cfg.guided_recompute

    def forward(
        self,
        sample: torch.Tensor,  # (B, F, H, W, C_in)
        timestep,  # int or 0-d / (B,) tensor
        encoder_hidden_states: torch.Tensor,  # (B, L, cross_attention_dim)
        *,
        guidance_blocks: Tuple[str, ...] = (),
        down_block_residuals: Optional[Tuple[torch.Tensor, ...]] = None,
        mid_block_residual: Optional[torch.Tensor] = None,
        max_up_block: Optional[int] = None,
        post_guidance_cut: Optional[int] = None,
        attention_impl: str = "flash",
        post_guidance_impl: Optional[str] = None,
        frame_group: Optional[FrameGroup] = None,
        added_cond: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[Optional[torch.Tensor], ProbsDict]:
        """Returns ``(noise_pred, probs)``; noise_pred is None when
        ``max_up_block`` cuts the forward short."""
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        probs: ProbsDict = {}
        impl = attention_impl
        for name in (impl, post_guidance_impl):
            if name not in ("flash", "fused", None):
                raise ValueError(f"unknown attention impl {name!r} (flash or fused)")
        sample = sample.to(dtype)
        context = encoder_hidden_states.to(dtype)
        b = sample.shape[0]

        t = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(b)
        t_emb = timestep_embedding(
            t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift
        ).to(dtype)
        temb = self.time_embedding(t_emb)
        if hasattr(self, "add_embedding") != (added_cond is not None):
            raise ValueError("added_cond (pooled text, time ids) is required by, and only "
                             "taken by, a UNet with the text_time embedding")
        if added_cond is not None:
            pooled, time_ids = added_cond
            ids = time_ids_embedding(time_ids, cfg.addition_time_embed_dim,
                                     cfg.flip_sin_to_cos, cfg.freq_shift)
            temb = temb + self.add_embedding(torch.cat([pooled.to(dtype), ids.to(dtype)], -1))

        x = spatial_conv(sample, self.conv_in)
        skips = [x]
        for block in self.down_blocks:
            if isinstance(block, CrossAttnDownBlock3D):
                x, block_skips, p = block(x, temb, context, guidance_blocks, impl,
                                          frame_group)
            else:
                x, block_skips, p = block(x, temb, guidance_blocks, impl, frame_group)
            skips.extend(block_skips)
            probs.update(p)
        if down_block_residuals is not None:
            if len(down_block_residuals) != len(skips):
                raise ValueError(f"{len(down_block_residuals)} down-block residuals for "
                                 f"{len(skips)} skips")
            skips = [s + r.to(s.dtype) for s, r in zip(skips, down_block_residuals)]

        x, p = self.mid_block(x, temb, context, guidance_blocks, impl, frame_group)
        probs.update(p)
        if mid_block_residual is not None:
            x = x + mid_block_residual.to(x.dtype)

        for i, block in enumerate(self.up_blocks):
            if max_up_block is not None and i > max_up_block:
                return None, probs  # extraction early exit
            n = len(block.resnets)
            block_skips = tuple(skips[-n:])
            del skips[-n:]
            post_cut = post_guidance_cut is not None and i > post_guidance_cut
            up_impl = (post_guidance_impl or impl) if post_cut else impl
            with torch.no_grad() if post_cut else contextlib.nullcontext():
                if post_cut:
                    x = x.detach()
                    block_skips = tuple(s.detach() for s in block_skips)
                if isinstance(block, CrossAttnUpBlock3D):
                    x, p = block(x, block_skips, temb, context, guidance_blocks, up_impl,
                                 frame_group)
                else:
                    x, p = block(x, block_skips, temb, guidance_blocks, up_impl,
                                 frame_group)
            probs.update(p)

        with (
            torch.no_grad() if post_guidance_cut is not None
            else contextlib.nullcontext()
        ):
            x = self.conv_norm_out(x, per_frame=cfg.use_inflated_groupnorm, silu=True)
            x = spatial_conv(x, self.conv_out)
        return x, probs
