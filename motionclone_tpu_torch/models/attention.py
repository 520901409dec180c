"""Spatial transformer: per-frame self- and cross-attention.

Port of ``motionclone_tpu/models/attention.py`` (the unfused path).
Submodule names follow the diffusers keys (``attn1.to_q``, ``attn1.to_out.0``,
``ff.net.0.proj``, ``ff.net.2``), so a diffusers state dict loads directly.

Self-attention (``attn1``) goes through the flash kernels at every
resolution; cross-attention (``attn2``, 77 text tokens) is plain PyTorch.

A Transformer3DModel holds ``num_layers`` BasicTransformerBlocks (one in
SD1.5, up to ten in SDXL), run in turn between its projections.

With ``impl="fused"``, under the JAX package's conditions and predicate
(``ops/fused_block.supported``) and, on CUDA, the kernels' own shape rule
(``ops/fused_block.device_supported``: :meth:`Transformer3DModel.fused_route`),
a whole single-layer Transformer3DModel with 1x1-conv projections runs as
kernel 5, and otherwise each of its BasicTransformerBlocks as kernel 6 (the
linear-projection and the multi-layer models): forward only, on weights
repacked once into the kernels' layout and cached on the module.
``impl="flash"`` and every other shape run the unfused path.  With
``recompute`` set on the module, under autograd each transformer layer's
activations are computed again in the backward (``layers.recompute``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from motionclone_tpu_torch.models.layers import GroupNorm, LayerNorm, recompute
from motionclone_tpu_torch.ops import fused_block
from motionclone_tpu_torch.ops.attention import dot_product_attention
from motionclone_tpu_torch.ops.fused_common import cached_pack, geglu_weights, takes_kernel


class CrossAttention(nn.Module):
    """Multi-head attention with q from x and k/v from the context (or x)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        out = dot_product_attention(
            self.to_q(x), self.to_k(ctx), self.to_v(ctx),
            heads=self.heads, scale=self.dim_head**-0.5,
            impl="flash" if context is None else "plain",
        )
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """diffusers GEGLU: project to 2*inner, gate with the exact (erf) GELU."""

    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner_dim * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """diffusers FeedForward with the geglu activation, mult=4 (``net.1`` is
    the dropout slot, an identity at inference)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """Self-attn + cross-attn + FF, each after a LayerNorm, with residuals."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int]):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.has_cross = cross_attention_dim is not None
        if self.has_cross:
            self.norm2 = LayerNorm(dim)
            self.attn2 = CrossAttention(dim, heads, dim_head, cross_attention_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def fused_weights(self, dtype: torch.dtype) -> fused_block.BlockWeights:
        """The block's weights in kernel 6's layout, matrices in ``dtype``."""
        def build():
            a1, a2 = self.attn1, self.attn2
            wff1, bff1 = geglu_weights(self.ff.net[0].proj, dtype)
            return fused_block.BlockWeights(
                self.norm1.weight.float(), self.norm1.bias.float(),
                torch.cat([a1.to_q.weight, a1.to_k.weight, a1.to_v.weight]).to(dtype),
                a1.to_out[0].weight.to(dtype), a1.to_out[0].bias.float(),
                self.norm2.weight.float(), self.norm2.bias.float(),
                a2.to_q.weight.to(dtype),
                torch.cat([a2.to_k.weight, a2.to_v.weight]).to(dtype),
                a2.to_out[0].weight.to(dtype), a2.to_out[0].bias.float(),
                self.norm3.weight.float(), self.norm3.bias.float(),
                wff1, bff1,
                self.ff.net[2].weight.to(dtype), self.ff.net[2].bias.float(),
            )
        return cached_pack(self, dtype, build)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        if self.has_cross:
            x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer3DModel(nn.Module):
    """Per-frame spatial transformer over a (B, F, H, W, C) video tensor: the
    text context is shared by every frame."""

    def __init__(self, in_channels: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = 768,
                 norm_num_groups: int = 32, use_linear_projection: bool = False,
                 num_layers: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.use_linear_projection = use_linear_projection
        self.recompute = False  # recompute each layer's activations in a backward
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(in_channels, inner)
            self.proj_out = nn.Linear(inner, in_channels)
        else:
            self.proj_in = nn.Conv2d(in_channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, in_channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim)
             for _ in range(num_layers)]
        )

    def _weight(self, layer: nn.Module) -> torch.Tensor:
        # a 1x1 conv on channels-last data is a dense layer on the last axis
        return layer.weight if self.use_linear_projection else layer.weight[:, :, 0, 0]

    def _project(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self._weight(layer), layer.bias)

    def fused_weights(self, dtype: torch.dtype) -> fused_block.TransformerWeights:
        """The model's weights in kernel 5's layout, matrices in ``dtype``."""
        def build():
            return fused_block.TransformerWeights(
                self.norm.weight.float(), self.norm.bias.float(),
                self._weight(self.proj_in).to(dtype).contiguous(),
                self.proj_in.bias.float(),
                self.transformer_blocks[0].fused_weights(dtype),
                self._weight(self.proj_out).to(dtype).contiguous(),
                self.proj_out.bias.float(),
            )
        return cached_pack(self, dtype, build)

    def fused_route(self, x_shape, context_shape, device_type: str) -> Optional[str]:
        """The fused kernel ``impl="fused"`` takes for a (B, F, H, W, C)
        input with (B, T, Dc) text on ``device_type``: "spatial_transformer"
        (kernel 5), "transformer_block" (kernel 6) or None (the unfused
        path), from the shapes alone."""
        b, f, hh, ww, c = x_shape
        block = self.transformer_blocks[0]
        heads, inner = block.attn1.heads, block.attn1.heads * block.attn1.dim_head
        if context_shape is None or not block.has_cross:
            return None
        t, dc = context_shape[-2:]
        if not takes_kernel(device_type, fused_block.supported(hh * ww, inner, heads),
                            lambda: fused_block.device_supported(hh * ww, inner, t, dc)):
            return None
        if not self.use_linear_projection and inner == c and len(self.transformer_blocks) == 1:
            return "spatial_transformer"
        return "transformer_block"

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                impl: str = "flash") -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        block = self.transformer_blocks[0]
        route = None if impl != "fused" else self.fused_route(
            x.shape, None if context is None else context.shape, x.device.type)
        if route == "spatial_transformer":
            out = fused_block.fused_spatial_transformer(
                x.reshape(b * f, hh * ww, c), context, self.fused_weights(x.dtype),
                heads=block.attn1.heads, groups=self.norm.num_groups, frames=f,
                eps=self.norm.eps,
            )
            return out.reshape(x.shape)
        h = self._project(self.proj_in, self.norm(x, per_frame=True))
        h = h.reshape(b * f, hh * ww, h.shape[-1])
        ctx = None
        if route is None and context is not None:
            ctx = context.repeat_interleave(f, dim=0)
        for block in self.transformer_blocks:
            if route == "transformer_block":
                h = fused_block.fused_transformer_block(
                    h, context, block.fused_weights(x.dtype), heads=block.attn1.heads,
                    frames=f)
            else:
                h = recompute(block, h, ctx, on=self.recompute)
        h = self._project(self.proj_out, h.reshape(b, f, hh, ww, h.shape[-1]))
        return h + x
