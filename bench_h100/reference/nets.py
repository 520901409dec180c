"""The plain reference networks: SD1.5's UNet with AnimateDiff v3's motion
modules, the SparseCtrl controlnet, the SD1.5 VAE and CLIP ViT-L/14's text
tower.

A frozen, plain-PyTorch copy of the measured program's model equations,
with the same submodule names (so one state dict fits both) and none of
its kernels, fused routes or frame sharding.  Activations are channels-last
video tensors (B, F, H, W, C).  Every matrix product sits in an
``nn.Linear`` or ``nn.Conv2d`` (``Dense1x1`` for a 1x1 convolution on
channels-last data), so the lower-precision control can round their
operands (``precision.py``).  Attention is explicit: f32 logits and
softmax, in blocks of the batch that bound the (rows, heads, S, S) logits.

Meant to run in float32 with TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

# logits elements held at once by one attention block (4 GiB in f32)
ATTN_BLOCK_ELEMS = 1 << 30


def attention(q, k, v, heads: int, scale: float, recompute: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v per head over (N, S, heads*D) tensors, in
    blocks of N.  ``recompute``: under autograd, keep q, k and v for the
    backward and compute the probabilities again there, in place of
    keeping them (the same values)."""
    if recompute and torch.is_grad_enabled():
        return checkpoint(attention, q, k, v, heads, scale, use_reentrant=False)
    n, sq, hd = q.shape
    sk, d = k.shape[1], hd // heads
    step = max(1, ATTN_BLOCK_ELEMS // (heads * sq * sk))
    outs = []
    for i in range(0, n, step):
        qh = q[i:i + step].reshape(-1, sq, heads, d).transpose(1, 2)
        kh = k[i:i + step].reshape(-1, sk, heads, d).transpose(1, 2)
        vh = v[i:i + step].reshape(-1, sk, heads, d).transpose(1, 2)
        p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
        outs.append(torch.matmul(p, vh).transpose(1, 2).reshape(-1, sq, hd))
    return torch.cat(outs)


def group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm over (N, ..., C) per sample and group."""
    n, c = x.shape[0], x.shape[-1]
    g = norm.num_groups
    xg = x.reshape(n, -1, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xg - mean) * torch.rsqrt(var + norm.eps)).reshape(x.shape)
    return y * norm.weight + norm.bias


def frame_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """AnimateDiff's InflatedGroupNorm: statistics per frame."""
    b, f = x.shape[:2]
    return group_norm(x.reshape(b * f, *x.shape[2:]), norm).reshape(x.shape)


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """A Conv2d over the frames (or images) of a channels-last tensor."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = layer(x.reshape(-1, h, w, c).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], y.shape[1])


class Dense1x1(nn.Conv2d):
    """A 1x1 convolution (its checkpoint layout) applied to channels-last
    data as a dense layer on the last axis."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0], self.bias)


def conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


def timestep_features(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep features (flip_sin_to_cos, freq_shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device,
                                                         dtype=torch.float32) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def positional_table(d: int, max_len: int) -> torch.Tensor:
    """The motion module's fixed sinusoidal table (max_len, d)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-math.log(10000.0) / d))
    pe = np.zeros((max_len, d))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32))


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, cout)
        self.linear_2 = nn.Linear(cout, cout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


# ---------------------------------------------------------------------------
# UNet pieces
# ---------------------------------------------------------------------------


class ResnetBlock3D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = conv3(cin, cout)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = conv3(cout, cout)
        self.conv_shortcut = Dense1x1(cin, cout) if cin != cout else None

    def forward(self, x, temb):
        h = conv(F.silu(frame_norm(x, self.norm1)), self.conv1)
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = conv(F.silu(frame_norm(h, self.norm2)), self.conv2)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim // heads
        self.recompute = False  # see attention()
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        out = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads,
                        self.dim_head ** -0.5, self.recompute)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer3DModel(nn.Module):
    """Per-frame spatial transformer; every frame sees its video's text."""

    def __init__(self, ch: int, heads: int, context_dim: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Dense1x1(ch, ch)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(ch, heads, context_dim)])
        self.proj_out = Dense1x1(ch, ch)

    def forward(self, x, context):
        b, f, hh, ww, c = x.shape
        h = self.proj_in(frame_norm(x, self.norm)).reshape(b * f, hh * ww, c)
        h = self.transformer_blocks[0](h, context.repeat_interleave(f, dim=0))
        return self.proj_out(h.reshape(x.shape)) + x


class VersatileAttention(nn.Module):
    """Temporal self-attention over the frames at each pixel; the
    positional table is added to the normed input before q/k/v."""

    def __init__(self, dim: int, heads: int, pe_len: int, use_pe: bool):
        super().__init__()
        self.heads, self.pe_len, self.use_pe = heads, pe_len, use_pe
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, want_probs: bool):
        b, f, s, c = x.shape
        hd, d = self.heads, c // self.heads
        if self.use_pe:
            x = x + positional_table(c, self.pe_len).to(x)[:f][None, :, None, :]

        def pixel_major(t):  # (B, F, S, C) -> (B*S, heads, F, D)
            return t.reshape(b, f, s, hd, d).permute(0, 2, 3, 1, 4).reshape(b * s, hd, f, d)

        q, k, v = (pixel_major(p(x)) for p in (self.to_q, self.to_k, self.to_v))
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5, dim=-1)
        out = torch.matmul(p, v).reshape(b, s, hd, f, d).permute(0, 3, 1, 2, 4)
        out = self.to_out[0](out.reshape(b, f, s, c))
        return out, (p.reshape(b, s, hd, f, f) if want_probs else None)


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, n_attn: int, pe_len: int, use_pe: bool):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            [VersatileAttention(dim, heads, pe_len, use_pe) for _ in range(n_attn)])
        self.norms = nn.ModuleList([nn.LayerNorm(dim) for _ in range(n_attn)])
        self.ff = FeedForward(dim)
        self.ff_norm = nn.LayerNorm(dim)

    def forward(self, x, want_probs: bool):
        probs = []
        for norm, attn in zip(self.norms, self.attention_blocks):
            out, p = attn(norm(x), want_probs)
            x = x + out
            probs.append(p)
        return x + self.ff(self.ff_norm(x)), probs


class TemporalTransformer3D(nn.Module):
    def __init__(self, ch: int, mm: Mapping):
        super().__init__()
        heads = mm["num_attention_heads"]
        if mm["temporal_attention_dim_div"] != 1:
            raise ValueError("the reference has temporal_attention_dim_div 1 only")
        self.norm = nn.GroupNorm(mm["norm_num_groups"], ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(ch, heads, len(mm["attention_block_types"]),
                                     mm["temporal_position_encoding_max_len"],
                                     mm["temporal_position_encoding"])
            for _ in range(mm["num_transformer_block"])])
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, want_probs: bool):
        b, f, hh, ww, c = x.shape
        h = self.proj_in(frame_norm(x, self.norm).reshape(b, f, hh * ww, c))
        probs = []
        for block in self.transformer_blocks:
            h, p = block(h, want_probs)
            probs += p
        return self.proj_out(h).reshape(x.shape) + x, probs


class VanillaTemporalModule(nn.Module):
    def __init__(self, ch: int, mm: Mapping):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3D(ch, mm)

    def forward(self, x, want_probs: bool):
        return self.temporal_transformer(x, want_probs)


class Block(nn.Module):
    """A down, mid or up block: resnets, optional spatial transformers and
    motion modules, optional down/upsampler.  ``kind`` is the diffusers
    block type."""

    def __init__(self, kind: str, path: str, in_chs: List[int], cout: int, cfg: Mapping,
                 use_mm: bool, resample: bool, n_resnets: int, n_attn: int):
        super().__init__()
        self.kind, self.path = kind, path
        temb, groups, eps = 4 * cfg["block_out_channels"][0], cfg["norm_num_groups"], cfg["norm_eps"]
        self.resnets = nn.ModuleList([ResnetBlock3D(c, cout, temb, groups, eps)
                                      for c in in_chs[:n_resnets]])
        self.attentions = nn.ModuleList([
            Transformer3DModel(cout, cfg["heads"], cfg["cross_attention_dim"], groups)
            for _ in range(n_attn)]) if n_attn else None
        n_mm = n_attn if kind == "mid" else n_resnets
        self.motion_modules = nn.ModuleList([
            VanillaTemporalModule(cout, cfg["motion_module"]) for _ in range(n_mm)]) \
            if use_mm else None
        if resample and kind.startswith("down"):
            self.downsamplers = nn.ModuleList([nn.Module()])
            self.downsamplers[0].conv = conv3(cout, cout, stride=2)
        if resample and kind.startswith("up"):
            self.upsamplers = nn.ModuleList([nn.Module()])
            self.upsamplers[0].conv = conv3(cout, cout)
        self.mm_cfg = cfg["motion_module"]

    def motion(self, x, i, guidance, probs):
        if self.motion_modules is None:
            return x
        mm_path = f"{self.path}.motion_modules.{i}"
        want = any(g in mm_path for g in guidance)
        x, p = self.motion_modules[i](x, want)
        if want:
            n_attn = len(self.mm_cfg["attention_block_types"])
            for j, pj in enumerate(p):
                probs[f"{mm_path}.temporal_transformer.transformer_blocks.{j // n_attn}"
                      f".attention_blocks.{j % n_attn}"] = pj
        return x

    def down(self, x, temb, context, guidance, probs):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            x = self.motion(x, i, guidance, probs)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = conv(x, self.downsamplers[0].conv)
            skips.append(x)
        return x, skips

    def mid(self, x, temb, context, guidance, probs):
        x = self.resnets[0](x, temb)
        for i, attn in enumerate(self.attentions):
            x = self.motion(attn(x, context), i, guidance, probs)
            x = self.resnets[i + 1](x, temb)
        return x

    def up(self, x, skips, temb, context, guidance, probs):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=-1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            x = self.motion(x, i, guidance, probs)
        if hasattr(self, "upsamplers"):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = conv(x, self.upsamplers[0].conv)
        return x


def unet_blocks(cfg: Mapping, down_only: bool = False):
    """(down blocks, mid block, up blocks, skip widths) of the UNet topology
    ``cfg`` (the UNet's, or the controlnet's down and mid half)."""
    chs, n = cfg["block_out_channels"], cfg["layers_per_block"]
    res = cfg["motion_module_resolutions"] if cfg["use_motion_module"] else ()
    down, skip, ch = nn.ModuleList(), [chs[0]], chs[0]
    for i, kind in enumerate(cfg["down_block_types"]):
        last = i == len(chs) - 1
        use_mm = 2 ** i in res and not cfg.get("motion_module_decoder_only", False)
        cross = kind == "CrossAttnDownBlock3D"
        down.append(Block("down", f"down_blocks.{i}", [ch] + [chs[i]] * n, chs[i], cfg,
                          use_mm, not last, n, n if cross else 0))
        ch = chs[i]
        skip += [ch] * (n + (not last))
    mid = Block("mid", "mid_block", [ch, ch], ch, cfg,
                cfg["use_motion_module"] and cfg["motion_module_mid_block"], False, 2, 1)
    if down_only:
        return down, mid, None, skip
    up, skips = nn.ModuleList(), list(skip)
    for i, kind in enumerate(cfg["up_block_types"]):
        cout = list(reversed(chs))[i]
        in_chs = []
        for _ in range(n + 1):
            in_chs.append(ch + skips.pop())
            ch = cout
        cross = kind == "CrossAttnUpBlock3D"
        up.append(Block("up", f"up_blocks.{i}", in_chs, cout, cfg,
                        2 ** (3 - i) in res, i < len(chs) - 1, n + 1, n + 1 if cross else 0))
    return down, mid, up, skip


def unet_topology(cfg: Mapping) -> Dict:
    """The UNet section of a configuration file, with the names the blocks
    read."""
    return dict(cfg, heads=cfg["attention_head_dim"])


class UNet3D(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        self.cfg = cfg = unet_topology(cfg)
        if not cfg["use_inflated_groupnorm"] or cfg["use_linear_projection"]:
            raise ValueError("the reference has the inflated GroupNorm and 1x1 projections only")
        ch0 = cfg["block_out_channels"][0]
        self.time_embedding = TimestepEmbedding(ch0, 4 * ch0)
        self.conv_in = conv3(cfg["in_channels"], ch0)
        self.down_blocks, self.mid_block, self.up_blocks, _ = unet_blocks(cfg)
        self.conv_norm_out = nn.GroupNorm(cfg["norm_num_groups"], ch0, eps=cfg["norm_eps"])
        self.conv_out = conv3(ch0, cfg["out_channels"])

    def forward(self, sample, t: int, context, guidance=(), residuals=None,
                max_up_block=None, grad_cut=None):
        """-> (noise prediction or None, {module name: probs}).
        ``max_up_block``: stop after that up block (extraction);
        ``grad_cut``: the up blocks after it, and the output head, run
        without grad (the guided step's conditional pass)."""
        probs: Dict[str, torch.Tensor] = {}
        b = sample.shape[0]
        temb = self.time_embedding(timestep_features(
            torch.full((b,), t, device=sample.device), self.cfg["block_out_channels"][0]))
        x = conv(sample, self.conv_in)
        skips = [x]
        for block in self.down_blocks:
            x, s = block.down(x, temb, context, guidance, probs)
            skips += s
        if residuals is not None:
            skips = [s + r for s, r in zip(skips, residuals[0])]
        x = self.mid_block.mid(x, temb, context, guidance, probs)
        if residuals is not None:
            x = x + residuals[1]
        for i, block in enumerate(self.up_blocks):
            if max_up_block is not None and i > max_up_block:
                return None, probs
            n = len(block.resnets)
            mine, skips = skips[-n:], skips[:-n]
            if grad_cut is not None and i > grad_cut:
                with torch.no_grad():
                    x = block.up(x.detach(), [s.detach() for s in mine], temb, context,
                                 guidance, probs)
            else:
                x = block.up(x, mine, temb, context, guidance, probs)
        with torch.no_grad() if grad_cut is not None else torch.enable_grad():
            x = conv(F.silu(frame_norm(x, self.conv_norm_out)), self.conv_out)
        return x, probs


class ControlNet(nn.Module):
    """SparseCtrl: the UNet's down and mid half over a (latent or pixel)
    condition with its mask, and 1x1 heads per skip and for the mid block."""

    def __init__(self, cfg: Mapping):
        super().__init__()
        self.cfg = cfg = unet_topology(dict(cfg, attention_head_dim=cfg["num_heads"]))
        ch0 = cfg["block_out_channels"][0]
        self.time_embedding = TimestepEmbedding(ch0, 4 * ch0)
        self.conv_in = conv3(cfg["in_channels"], ch0)
        cin = cfg["conditioning_channels"] + int(cfg["concate_conditioning_mask"])
        if cfg["use_simplified_condition_embedding"]:
            self.controlnet_cond_embedding = conv3(cin, ch0)
        else:
            emb = nn.Module()
            boc = cfg["conditioning_embedding_out_channels"]
            emb.conv_in = conv3(cin, boc[0])
            emb.blocks = nn.ModuleList(
                [c for i in range(len(boc) - 1)
                 for c in (conv3(boc[i], boc[i]), conv3(boc[i], boc[i + 1], stride=2))])
            emb.conv_out = conv3(boc[-1], ch0)
            self.controlnet_cond_embedding = emb
        self.down_blocks, self.mid_block, _, skip = unet_blocks(cfg, down_only=True)
        self.controlnet_down_blocks = nn.ModuleList([Dense1x1(c, c) for c in skip])
        self.controlnet_mid_block = Dense1x1(skip[-1], skip[-1])

    def forward(self, sample, t: int, context, cond, mask, scale):
        """-> (down residuals, mid residual); ``scale`` a float or (B, 1,
        1, 1, 1)."""
        cfg = self.cfg
        b = sample.shape[0]
        temb = self.time_embedding(timestep_features(
            torch.full((b,), t, device=sample.device), cfg["block_out_channels"][0]))
        if cfg["set_noisy_sample_input_to_zero"]:
            # conv_in of zeros is its bias at every pixel
            x = self.conv_in.bias.expand(*sample.shape[:-1], -1)
        else:
            x = conv(sample, self.conv_in)
        if cfg["concate_conditioning_mask"]:
            cond = torch.cat([cond, mask], dim=-1)
        emb = self.controlnet_cond_embedding
        if isinstance(emb, nn.Conv2d):
            x = x + conv(cond, emb)
        else:
            h = F.silu(conv(cond, emb.conv_in))
            for c in emb.blocks:
                h = F.silu(conv(h, c))
            x = x + conv(h, emb.conv_out)
        skips, probs = [x], {}
        for block in self.down_blocks:
            x, s = block.down(x, temb, context, (), probs)
            skips += s
        x = self.mid_block.mid(x, temb, context, (), probs)
        down = [head(s) * scale for s, head in zip(skips, self.controlnet_down_blocks)]
        return down, self.controlnet_mid_block(x) * scale


def scatter_condition(frames: torch.Tensor, image_index, video_length: int):
    """Zeros with the condition frames (B, N, H, W, C) at ``image_index``,
    and the one-channel mask of those frames."""
    b, _, h, w, c = frames.shape
    cond = frames.new_zeros((b, video_length, h, w, c))
    mask = frames.new_zeros((b, video_length, h, w, 1))
    idx = list(image_index)
    cond[:, idx] = frames
    mask[:, idx] = 1.0
    return cond, mask


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = conv3(cin, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = conv3(cout, cout)
        self.conv_shortcut = Dense1x1(cin, cout) if cin != cout else None

    def forward(self, x):
        h = conv(F.silu(group_norm(x, self.norm1)), self.conv1)
        h = conv(F.silu(group_norm(h, self.norm2)), self.conv2)
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class AttentionBlock2D(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q, self.to_k, self.to_v = (nn.Linear(ch, ch) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        n, h, w, c = x.shape
        y = group_norm(x, self.group_norm).reshape(n, h * w, c)
        out = attention(self.to_q(y), self.to_k(y), self.to_v(y), 1, c ** -0.5)
        return x + self.to_out[0](out).reshape(x.shape)


class MidBlock2D(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([AttentionBlock2D(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAE(nn.Module):
    """AutoencoderKL: encode pixels (N, H, W, 3) -> (mean, logvar); decode
    latents (N, h, w, 4) -> pixels.  Callers scale the latents."""

    def __init__(self, cfg: Mapping):
        super().__init__()
        self.cfg = cfg
        chs, g, n = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
        lat = cfg["latent_channels"]
        enc = self.encoder = nn.Module()
        enc.conv_in = conv3(cfg["in_channels"], chs[0])
        enc.down_blocks = nn.ModuleList()
        for i, ch in enumerate(chs):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([ResnetBlock2D(chs[max(i - 1, 0)] if j == 0 else ch,
                                                       ch, g) for j in range(n)])
            if i < len(chs) - 1:
                blk.downsamplers = nn.ModuleList([nn.Module()])
                blk.downsamplers[0].conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0)
            enc.down_blocks.append(blk)
        enc.mid_block = MidBlock2D(chs[-1], g)
        enc.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        enc.conv_out = conv3(chs[-1], 2 * lat)
        dec = self.decoder = nn.Module()
        rch = list(reversed(chs))
        dec.conv_in = conv3(lat, rch[0])
        dec.mid_block = MidBlock2D(rch[0], g)
        dec.up_blocks = nn.ModuleList()
        for i, ch in enumerate(rch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([ResnetBlock2D(rch[max(i - 1, 0)] if j == 0 else ch,
                                                       ch, g) for j in range(n + 1)])
            if i < len(rch) - 1:
                blk.upsamplers = nn.ModuleList([nn.Module()])
                blk.upsamplers[0].conv = conv3(ch, ch)
            dec.up_blocks.append(blk)
        dec.conv_norm_out = nn.GroupNorm(g, chs[0], eps=1e-6)
        dec.conv_out = conv3(chs[0], cfg["out_channels"])
        self.quant_conv = Dense1x1(2 * lat, 2 * lat)
        self.post_quant_conv = Dense1x1(lat, lat)

    def encode(self, x):
        enc = self.encoder
        x = conv(x, enc.conv_in)
        for blk in enc.down_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "downsamplers"):
                x = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
                x = blk.downsamplers[0].conv(x).permute(0, 2, 3, 1)
        x = enc.mid_block(x)
        x = conv(F.silu(group_norm(x, enc.conv_norm_out)), enc.conv_out)
        return self.quant_conv(x).chunk(2, dim=-1)

    def decode(self, z):
        dec = self.decoder
        x = dec.mid_block(conv(self.post_quant_conv(z), dec.conv_in))
        for blk in dec.up_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "upsamplers"):
                x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                x = conv(x, blk.upsamplers[0].conv)
        return conv(F.silu(group_norm(x, dec.conv_norm_out)), dec.conv_out)


# ---------------------------------------------------------------------------
# CLIP text tower
# ---------------------------------------------------------------------------


class CLIPLayer(nn.Module):
    def __init__(self, d: int, heads: int, inner: int, eps: float):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        att = self.self_attn = nn.Module()
        att.q_proj, att.k_proj, att.v_proj, att.out_proj = (nn.Linear(d, d) for _ in range(4))
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        mlp = self.mlp = nn.Module()
        mlp.fc1, mlp.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)

    def forward(self, x, mask):
        b, s, d = x.shape
        hd = d // self.heads
        att = self.self_attn
        h = self.layer_norm1(x)

        def split(t):
            return t.reshape(b, s, self.heads, hd).transpose(1, 2)

        q, k, v = split(att.q_proj(h)), split(att.k_proj(h)), split(att.v_proj(h))
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5 + mask, dim=-1)
        x = x + att.out_proj(torch.matmul(p, v).transpose(1, 2).reshape(b, s, d))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


class CLIPText(nn.Module):
    """Token ids (N, 77) -> last hidden state (N, 77, hidden)."""

    def __init__(self, cfg: Mapping):
        super().__init__()
        if cfg["hidden_act"] != "quick_gelu":
            raise ValueError(f"the reference has quick_gelu only, not {cfg['hidden_act']!r}")
        d = cfg["hidden_size"]
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([
            CLIPLayer(d, cfg["num_heads"], cfg["intermediate_size"], cfg["layer_norm_eps"])
            for _ in range(cfg["num_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=cfg["layer_norm_eps"])

    def forward(self, ids):
        tm = self.text_model
        s = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(
            torch.arange(s, device=ids.device))[None]
        mask = torch.full((s, s), float("-inf"), device=ids.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


class initialisers_off:
    """``torch.nn.init``'s in-place initialisers as no-ops, for building on
    the meta device: an embedding's normal_ there imports torch's Python
    meta kernels, seconds in a fresh process, for values never used."""

    def __enter__(self):
        init = torch.nn.init
        self.saved = {n: getattr(init, n) for n in dir(init)
                      if n.endswith("_") and not n.startswith("_")}
        for n in self.saved:
            setattr(init, n, lambda tensor, *args, **kwargs: tensor)

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch.nn.init, n, fn)


def build(config: Mapping, device="meta", dtype=torch.float32) -> Dict[str, nn.Module]:
    """The configuration's networks, with uninitialised parameters on
    ``device``: {"unet", "vae", "text_encoder"[, "controlnet"]}."""
    with torch.device("meta"), initialisers_off():
        nets = {"unet": UNet3D(config["unet"]), "vae": VAE(config["vae"]),
                "text_encoder": CLIPText(config["text_encoder"])}
        if config.get("controlnet"):
            nets["controlnet"] = ControlNet(config["controlnet"])
    if device != "meta":
        nets = {k: m.to_empty(device=device).to(dtype) for k, m in nets.items()}
    return {k: m.eval().requires_grad_(False) for k, m in nets.items()}
