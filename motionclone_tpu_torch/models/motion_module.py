"""Temporal motion module (AnimateDiff) with explicit probability output.

Port of ``motionclone_tpu/models/motion_module.py``.  Submodule names
follow the motion-module checkpoint keys
(``temporal_transformer.transformer_blocks.0.attention_blocks.0.to_q`` ...).

Temporal attention outside the guidance blocks goes through kernels 3 and 4
on the natural (B, F, S, C) layout.  Where the probabilities are requested
(the guidance blocks) they are formed with an explicit softmax that autograd
differentiates, and returned as (B, S, heads, F, F) float32.

With ``impl="fused"``, under the JAX package's conditions and predicate
(``ops/fused_temporal.supported``) and, on CUDA, the kernel's own shape rule
(``ops/fused_temporal.device_supported``:
:meth:`TemporalTransformer3D.fused_route`), a module whose probabilities are
not requested runs as kernel 7, forward only, on its weights repacked once into
the kernel's layout and cached on the module.

With a ``frame_group`` (the JAX package's ``frames_axis``: frame-sharded
sampling, ``parallel/frames.py``) x holds the rank's f local frames of F.
The rank adds rows [rank * f, (rank + 1) * f) of the positional encoding,
gathers k and v over the group, and attends with its local queries: kernels
3r and 4r, or probabilities of shape (B, S, heads, f, F).  Kernel 7 is off.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from motionclone_tpu_torch.config import MotionModuleConfig
from motionclone_tpu_torch.models.attention import FeedForward
from motionclone_tpu_torch.models.embeddings import temporal_positional_encoding
from motionclone_tpu_torch.models.layers import GroupNorm, LayerNorm
from motionclone_tpu_torch.ops import fused_temporal
from motionclone_tpu_torch.ops.attention import attention_probs
from motionclone_tpu_torch.ops.fused_common import cached_pack, geglu_weights, takes_kernel
from motionclone_tpu_torch.ops.temporal_attention import temporal_attention
from motionclone_tpu_torch.parallel.frames import FrameGroup


def _to_pixel_major(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, F, S, heads*D) -> (B*S, F, heads, D)."""
    b, f, s, hd = x.shape
    return (
        x.reshape(b, f, s, heads, hd // heads)
        .permute(0, 2, 1, 3, 4)
        .reshape(b * s, f, heads, hd // heads)
    )


class VersatileAttention(nn.Module):
    """Temporal self-attention over the F frames at each pixel.  The
    sinusoidal positional encoding is added to the (LayerNormed) input
    before the q/k/v projections.  Returns ``(out, probs)``, probs
    (B, S, heads, f, F) float32 when requested, else None: f local query
    frames (F without a frame group) against F key frames."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 use_pos_encoding: bool = True, pos_encoding_max_len: int = 24):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.use_pos_encoding = use_pos_encoding
        self.pos_encoding_max_len = pos_encoding_max_len
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        # the fixed table, per (device, dtype): a constant, not a parameter
        self._pe: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}

    def _pos_encoding(self, x: torch.Tensor) -> torch.Tensor:
        key = (x.device, x.dtype)
        if key not in self._pe:
            pe = temporal_positional_encoding(x.shape[-1], self.pos_encoding_max_len)
            self._pe[key] = torch.from_numpy(pe).to(device=x.device, dtype=x.dtype)
        return self._pe[key]

    def forward(
        self, x: torch.Tensor, return_probs: bool = False,
        frame_group: Optional[FrameGroup] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b, f, s, _ = x.shape
        fk = f * frame_group.size if frame_group is not None else f
        h = x
        if self.use_pos_encoding:
            pe = self._pos_encoding(x)
            if fk > pe.shape[0]:
                raise ValueError(
                    f"video_length {fk} exceeds the positional-encoding table "
                    f"({pe.shape[0]} rows)"
                )
            start = frame_group.rank * f if frame_group is not None else 0
            h = h + pe[start:start + f][None, :, None, :]
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        if frame_group is not None:
            # local queries against the keys and values of every frame
            k, v = frame_group.all_gather(k), frame_group.all_gather(v)
        scale = self.dim_head**-0.5
        probs = None
        if return_probs:
            # the f x F probability block is the motion feature
            p = attention_probs(
                _to_pixel_major(q, self.heads), _to_pixel_major(k, self.heads), scale
            )  # (B*S, heads, f, F)
            probs = p.reshape(b, s, self.heads, f, fk)
            vp = _to_pixel_major(v, self.heads)
            out = torch.einsum("bhqk,bkhd->bqhd", p.to(vp.dtype), vp)
            out = out.reshape(b, s, f, -1).transpose(1, 2)
        else:
            out = temporal_attention(q, k, v, heads=self.heads, scale=scale)
        return self.to_out[0](out), probs


class TemporalTransformerBlock(nn.Module):
    """Temporal attention blocks then a feed-forward, each after a LayerNorm."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 attention_block_types: Tuple[str, ...], use_pos_encoding: bool,
                 pos_encoding_max_len: int):
        super().__init__()
        for t in attention_block_types:
            if t != "Temporal_Self":
                raise ValueError(f"unsupported attention block type {t!r}")
        self.attention_blocks = nn.ModuleList(
            [VersatileAttention(dim, heads, dim_head, use_pos_encoding,
                                pos_encoding_max_len)
             for _ in attention_block_types]
        )
        self.norms = nn.ModuleList([LayerNorm(dim) for _ in attention_block_types])
        self.ff = FeedForward(dim)
        self.ff_norm = LayerNorm(dim)

    def forward(
        self, x: torch.Tensor, return_probs: bool = False,
        frame_group: Optional[FrameGroup] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        probs_out = []
        for norm, attn in zip(self.norms, self.attention_blocks):
            out, probs = attn(norm(x), return_probs=return_probs,
                              frame_group=frame_group)
            x = x + out
            if return_probs:
                probs_out.append(probs)
        return x + self.ff(self.ff_norm(x)), tuple(probs_out)


class TemporalTransformer3D(nn.Module):
    """GroupNorm -> proj_in -> temporal blocks -> proj_out -> +residual, on
    (B, F, H, W, C)."""

    def __init__(self, in_channels: int, cfg: MotionModuleConfig,
                 zero_init_proj_out: bool = True):
        super().__init__()
        heads = cfg.num_attention_heads
        dim_head = in_channels // heads // cfg.temporal_attention_dim_div
        inner = heads * dim_head
        self.norm = GroupNorm(cfg.norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(
                inner, heads, dim_head, cfg.attention_block_types,
                cfg.temporal_position_encoding,
                cfg.temporal_position_encoding_max_len,
            )
            for _ in range(cfg.num_transformer_block)
        ])
        self.proj_out = nn.Linear(inner, in_channels)
        if zero_init_proj_out:
            nn.init.zeros_(self.proj_out.weight)
            nn.init.zeros_(self.proj_out.bias)
        self.cfg, self.heads, self.inner = cfg, heads, inner

    def fused_weights(self, x: torch.Tensor) -> fused_temporal.TemporalModuleWeights:
        """The module's weights in kernel 7's layout, matrices in x's dtype."""
        dtype = x.dtype
        blk = self.transformer_blocks[0]

        def build():
            attn = tuple(
                fused_temporal.AttnWeights(
                    norm.weight.float(), norm.bias.float(),
                    torch.cat([a.to_q.weight, a.to_k.weight, a.to_v.weight]).to(dtype),
                    a.to_out[0].weight.to(dtype), a.to_out[0].bias.float(),
                )
                for norm, a in zip(blk.norms, blk.attention_blocks)
            )
            a0 = blk.attention_blocks[0]
            wff1, bff1 = geglu_weights(blk.ff.net[0].proj, dtype)
            return fused_temporal.TemporalModuleWeights(
                self.norm.weight.float(), self.norm.bias.float(),
                a0._pos_encoding(x) if a0.use_pos_encoding else None,
                self.proj_in.weight.to(dtype), self.proj_in.bias.float(),
                attn, blk.ff_norm.weight.float(), blk.ff_norm.bias.float(),
                wff1, bff1, blk.ff.net[2].weight.to(dtype), blk.ff.net[2].bias.float(),
                self.proj_out.weight.to(dtype), self.proj_out.bias.float(),
            )
        return cached_pack(self, dtype, build)

    def fused_route(self, x_shape, device_type: str, return_probs: bool = False,
                    frame_group: Optional[FrameGroup] = None) -> bool:
        """Whether ``impl="fused"`` runs kernel 7 for a (B, F, H, W, C) input
        on ``device_type``, from the shapes alone."""
        b, f, hh, ww, c = x_shape
        if (frame_group is not None or return_probs or self.inner != c
                or self.cfg.num_transformer_block != 1):
            return False
        n_attn = len(self.transformer_blocks[0].attention_blocks)
        return takes_kernel(device_type, fused_temporal.supported(f, hh * ww, c, self.heads),
                            lambda: fused_temporal.device_supported(hh * ww, c, n_attn))

    def forward(
        self, x: torch.Tensor, return_probs: bool = False, impl: str = "flash",
        frame_group: Optional[FrameGroup] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        b, f, hh, ww, c = x.shape
        if impl == "fused" and self.fused_route(x.shape, x.device.type, return_probs,
                                                frame_group):
            out = fused_temporal.fused_temporal_module(
                x.reshape(b, f, hh * ww, c), self.fused_weights(x),
                heads=self.heads, groups=self.norm.num_groups, eps=self.norm.eps,
            )
            return out.reshape(x.shape), ()
        h = self.norm(x, per_frame=True).reshape(b, f, hh * ww, c)
        h = self.proj_in(h)
        all_probs = []
        for block in self.transformer_blocks:
            h, probs = block(h, return_probs=return_probs, frame_group=frame_group)
            all_probs.extend(probs)
        h = self.proj_out(h).reshape(b, f, hh, ww, c)
        return h + x, tuple(all_probs)


class VanillaTemporalModule(nn.Module):
    """The checkpoint nesting ``motion_modules.N.temporal_transformer``;
    ``zero_initialize`` makes the module an identity at init."""

    def __init__(self, in_channels: int, cfg: MotionModuleConfig):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3D(
            in_channels, cfg, zero_init_proj_out=cfg.zero_initialize
        )

    def forward(
        self, x: torch.Tensor, return_probs: bool = False, impl: str = "flash",
        frame_group: Optional[FrameGroup] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        return self.temporal_transformer(x, return_probs=return_probs, impl=impl,
                                         frame_group=frame_group)
