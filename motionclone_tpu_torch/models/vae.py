"""AutoencoderKL (the SD1.5 VAE), channels-last.

Port of ``motionclone_tpu/models/vae.py``.  Submodule names follow the
diffusers keys (``encoder.down_blocks.0.resnets.0.norm1`` ...).  Frames of a
video (B, F, H, W, 3) are folded into the batch and processed in chunks of
``frame_chunk`` frames, which bounds the activations (and the mid-block
attention's 4096 x 4096 logits per frame at 512x512) held at once.  The
mid-block attention is single-head plain PyTorch with f32 softmax.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from motionclone_tpu_torch.models.layers import GroupNorm, conv2d


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A Conv2d applied to an (N, H, W, C) tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=1e-6)
        self.conv1 = conv2d(in_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=1e-6)
        self.conv2 = conv2d(out_channels, out_channels)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(self.norm1(x, silu=True), self.conv1)
        h = _conv(self.norm2(h, silu=True), self.conv2)
        if self.conv_shortcut is not None:
            x = _conv(x, self.conv_shortcut)
        return x + h


class AttentionBlock2D(nn.Module):
    """Single-head full-channel self-attention over the spatial positions."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        y = self.group_norm(x).reshape(n, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.bmm(q.float(), k.float().transpose(1, 2)) * c**-0.5
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = self.to_out[0](torch.bmm(probs, v))
        return x + out.reshape(n, h, w, c)


class Downsample2D(nn.Module):
    """Stride-2 conv with diffusers' asymmetric (0, 1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
        return self.conv(y).permute(0, 2, 3, 1)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv2d(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return _conv(x, self.conv)


class MidBlock2D(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(channels, channels, groups) for _ in range(2)]
        )
        self.attentions = nn.ModuleList([AttentionBlock2D(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, channels: int, num_layers: int,
                 groups: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else channels, channels, groups)
            for j in range(num_layers)
        ])
        self.downsamplers = (
            nn.ModuleList([Downsample2D(channels)]) if add_downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, channels: int, num_layers: int,
                 groups: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else channels, channels, groups)
            for j in range(num_layers)
        ])
        self.upsamplers = (
            nn.ModuleList([Upsample2D(channels)]) if add_upsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = conv2d(cfg.in_channels, chs[0])
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock2D(chs[max(i - 1, 0)], ch, cfg.layers_per_block, g,
                               i < len(chs) - 1)
            for i, ch in enumerate(chs)
        ])
        self.mid_block = MidBlock2D(chs[-1], g)
        self.conv_norm_out = GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = conv2d(chs[-1], 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv(x, self.conv_in)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return _conv(self.conv_norm_out(x, silu=True), self.conv_out)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = conv2d(cfg.latent_channels, chs[0])
        self.mid_block = MidBlock2D(chs[0], g)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock2D(chs[max(i - 1, 0)], ch, cfg.layers_per_block + 1, g,
                             i < len(chs) - 1)
            for i, ch in enumerate(chs)
        ])
        self.conv_norm_out = GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = conv2d(chs[-1], cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(_conv(z, self.conv_in))
        for block in self.up_blocks:
            x = block(x)
        return _conv(self.conv_norm_out(x, silu=True), self.conv_out)


class AutoencoderKL(nn.Module):
    """encode: pixels (B, F, H, W, 3) in [-1, 1] -> (mean, logvar) latents;
    decode: latents (B, F, h, w, 4) -> pixels.  Scaling by
    ``scaling_factor`` is the caller's concern."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def _per_frames(self, fn, x: torch.Tensor, frame_chunk: int):
        b, f = x.shape[:2]
        xf = x.reshape(b * f, *x.shape[2:]).to(self.quant_conv.weight.dtype)
        out = torch.cat([fn(xf[i:i + frame_chunk]) for i in range(0, b * f, frame_chunk)])
        return out.reshape(b, f, *out.shape[1:])

    def encode(self, x: torch.Tensor, frame_chunk: int = 4
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self._per_frames(
            lambda y: _conv(self.encoder(y), self.quant_conv), x, frame_chunk
        )
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar

    def decode(self, z: torch.Tensor, frame_chunk: int = 4) -> torch.Tensor:
        return self._per_frames(
            lambda y: self.decoder(_conv(y, self.post_quant_conv)), z, frame_chunk
        )


def sample_latents(mean: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """Reparameterised draw from the posterior (DiagonalGaussian.sample)
    with the standard normal noise ``eps`` (float32, ``mean``'s shape)."""
    std = torch.exp(0.5 * logvar.float().clamp(-30.0, 20.0))
    return (mean.float() + std * eps).to(mean.dtype)
