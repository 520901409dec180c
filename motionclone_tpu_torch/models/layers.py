"""Video-tensor primitives in channels-last layout.

Port of ``motionclone_tpu/models/layers.py``.  Activations are
``(batch, frames, height, width, channels)``, the JAX package's layout: the
attention projections and both attention kernels read it without a
transpose.  A convolution folds frames into the batch and presents the
tensor to ``conv2d`` as NCHW with channels-last strides (a view, no copy).
Norm statistics are float32 whatever the activation dtype.  On the card
the GroupNorm (and the SiLU after it) runs the hand-written differentiable
kernels of ``ops/group_norm.py``; on the CPU it runs the plain chain below.
:func:`recompute` runs a module so that a backward computes its activations
again instead of keeping them (the guided pass's ``guided_recompute``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from motionclone_tpu_torch.ops import group_norm as gn_ops
from motionclone_tpu_torch.ops.fused_common import cached_pack
from motionclone_tpu_torch.utils import trace

# segments run again in a backward over the process's life (it only grows:
# callers take differences)
_RECOMPUTED = [0]


@contextlib.contextmanager
def _rerun():
    """A segment's re-run in the backward: counted, and recorded as the
    ``unet_guided_recompute`` span."""
    _RECOMPUTED[0] += 1
    with trace.span("unet_guided_recompute"):
        yield


def recomputed_segments() -> int:
    """How many segments :func:`recompute` has run again in a backward so
    far in this process."""
    return _RECOMPUTED[0]


def recompute(fn, *args, on: bool = True):
    """``fn(*args)``; with ``on`` and under autograd, its activations are
    not kept for the backward but computed again there from ``args``
    (``torch.utils.checkpoint``), the same values: a backward's gradients
    are unchanged.  Each re-run is counted (:func:`recomputed_segments`)
    and recorded as a ``unet_guided_recompute`` span."""
    if not on or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _rerun()))


def spatial_conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Per-frame 2D convolution of a (B, F, H, W, C) tensor (AnimateDiff's
    ``InflatedConv3d``)."""
    b, f, h, w, c = x.shape
    y = conv(x.reshape(b * f, h, w, c).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).reshape(b, f, y.shape[2], y.shape[3], y.shape[1])


def conv2d(in_channels: int, out_channels: int, stride: int = 1) -> nn.Conv2d:
    """A 3x3 convolution with torch's symmetric padding of 1."""
    return nn.Conv2d(in_channels, out_channels, 3, stride=stride, padding=1)


def group_norm_nhwc(
    x: torch.Tensor, num_groups: int, eps: float, weight: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """GroupNorm over (N, ..., C) with f32 statistics per sample and group,
    result in x's dtype."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.reshape(n, -1, num_groups, c // num_groups).float()
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out.reshape(x.shape) * weight.float() + bias.float()
    return out.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (same parameters and state-dict keys) applied to a
    channels-last tensor, then SiLU with ``silu``.  On a video tensor,
    ``per_frame`` statistics reproduce AnimateDiff's ``InflatedGroupNorm``;
    otherwise they span the frames too.

    A CUDA tensor takes the kernels of ``ops/group_norm.py``, differentiable
    with respect to x only: the affine parameters go in as constants (an f32
    copy cached on the module), so no gradient reaches them.  Any other
    tensor takes ``group_norm_nhwc`` (then ``F.silu``) under autograd."""

    def forward(self, x: torch.Tensor, per_frame: bool = True,
                silu: bool = False) -> torch.Tensor:
        if x.device.type == "cuda":
            weight, bias = cached_pack(
                self, torch.float32, lambda: (self.weight.float(), self.bias.float()))
            return gn_ops.group_norm(x, weight, bias, self.num_groups, self.eps,
                                     silu=silu, per_frame=per_frame)
        if x.dim() == 5 and per_frame:
            b, f = x.shape[:2]
            out = group_norm_nhwc(
                x.reshape(b * f, *x.shape[2:]), self.num_groups, self.eps,
                self.weight, self.bias,
            ).reshape(x.shape)
        else:
            out = group_norm_nhwc(x, self.num_groups, self.eps, self.weight, self.bias)
        return F.silu(out) if silu else out


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last axis with f32 statistics, result in the
    input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(x.dtype)


class Upsample(nn.Module):
    """Nearest 2x spatial upsample + 3x3 conv; frames untouched."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv2d(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return spatial_conv(x, self.conv)


class Downsample(nn.Module):
    """Stride-2 3x3 conv downsample."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv2d(channels, channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spatial_conv(x, self.conv)
