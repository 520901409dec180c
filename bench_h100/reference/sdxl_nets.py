"""The plain reference networks of the SDXL family: SDXL base 1.0's UNet
with AnimateDiff-SDXL's motion modules, the SD VAE, CLIP ViT-L/14's and
OpenCLIP ViT-bigG/14's text towers.

A frozen, plain-PyTorch copy of the measured program's model equations
with the program's submodule names (so one state dict fits both), built
from ``nets.py``'s pieces where SDXL shares them (resnets, the transformer
block, the motion module, the VAE, the CLIP layer's attention) and none of
the program's kernels or fused routes.  What SDXL adds:

* the UNet's levels read from ``block_out_channels`` (three), a head count
  and a transformer depth per level (``attention_head_dim``,
  ``transformer_layers_per_block``; the mid block takes the last level's),
  linear ``proj_in`` / ``proj_out``, motion modules placed by level;
* the ``text_time`` embedding: each of the six size and crop ids through
  the 256-wide sinusoid, joined after the pooled text (2816), through
  ``add_embedding`` (Linear, SiLU, Linear) and added to the time embedding;
* the text towers' penultimate hidden state (no final LayerNorm), joined to
  the UNet's 2048-wide context, and bigG's pooled text: its final-LayerNorm
  state at the EOS position (the largest id) through ``text_projection``.

A conditioning is the tuple (context, pooled, time ids).  With ``recompute``
set on the UNet (``set_recompute``), under autograd every resnet, motion
module and transformer layer keeps only its inputs and runs again in the
backward (``torch.utils.checkpoint``): the f32 guided backward at 1024 x
1024 x 16 then fits the card.  Meant to run in float32 with TF32 off.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from bench_h100.reference import nets
from bench_h100.reference.nets import (
    VAE,
    BasicTransformerBlock,
    TimestepEmbedding,
    conv,
    conv3,
    frame_norm,
    initialisers_off,
    timestep_features,
)


def _maybe_checkpoint(module: nn.Module, fn, *args):
    if module.recompute and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class ResnetBlock3D(nets.ResnetBlock3D):
    recompute = False

    def forward(self, x, temb):
        return _maybe_checkpoint(self, super().forward, x, temb)


class VanillaTemporalModule(nets.VanillaTemporalModule):
    recompute = False

    def forward(self, x, want_probs: bool):
        return _maybe_checkpoint(self, super().forward, x, want_probs)


class Transformer3DModel(nn.Module):
    """SDXL's spatial transformer: GroupNorm, a linear proj_in, ``layers``
    transformer blocks, a linear proj_out, the residual."""

    recompute = False

    def __init__(self, ch: int, heads: int, context_dim: int, groups: int, layers: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, context_dim) for _ in range(layers)])
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context):
        b, f, hh, ww, c = x.shape
        h = self.proj_in(frame_norm(x, self.norm)).reshape(b * f, hh * ww, c)
        ctx = context.repeat_interleave(f, dim=0)
        for block in self.transformer_blocks:
            h = _maybe_checkpoint(self, block, h, ctx)
        return self.proj_out(h.reshape(x.shape)) + x


class Block(nets.Block):
    """A down, mid or up block of SDXL's UNet (``nets.Block``'s forward
    passes) with its level's heads and transformer depth."""

    def __init__(self, kind: str, path: str, in_chs: List[int], cout: int, cfg: Mapping,
                 use_mm: bool, resample: bool, n_resnets: int, n_attn: int, heads: int,
                 layers: int):
        nn.Module.__init__(self)
        self.kind, self.path = kind, path
        temb, groups, eps = (4 * cfg["block_out_channels"][0], cfg["norm_num_groups"],
                             cfg["norm_eps"])
        self.resnets = nn.ModuleList([ResnetBlock3D(c, cout, temb, groups, eps)
                                      for c in in_chs[:n_resnets]])
        self.attentions = nn.ModuleList([
            Transformer3DModel(cout, heads, cfg["cross_attention_dim"], groups, layers)
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


def _per_level(value, level: int) -> int:
    return value if isinstance(value, int) else value[level]


class UNet3D(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        self.cfg = cfg
        if cfg["addition_embed_type"] != "text_time" or not cfg["use_linear_projection"] \
                or not cfg["use_inflated_groupnorm"]:
            raise ValueError("the SDXL reference has the text_time embedding, linear "
                             "projections and the inflated GroupNorm only")
        chs, n = cfg["block_out_channels"], cfg["layers_per_block"]
        heads, depth = cfg["attention_head_dim"], cfg["transformer_layers_per_block"]
        res = cfg["motion_module_resolutions"] if cfg["use_motion_module"] else ()
        levels = len(chs)
        ch0 = chs[0]
        self.time_embedding = TimestepEmbedding(ch0, 4 * ch0)
        self.add_embedding = TimestepEmbedding(cfg["projection_class_embeddings_input_dim"],
                                               4 * ch0)
        self.conv_in = conv3(cfg["in_channels"], ch0)
        self.down_blocks, skip, ch = nn.ModuleList(), [ch0], ch0
        for i, kind in enumerate(cfg["down_block_types"]):
            last = i == levels - 1
            cross = kind == "CrossAttnDownBlock3D"
            self.down_blocks.append(Block(
                "down", f"down_blocks.{i}", [ch] + [chs[i]] * n, chs[i], cfg, 2 ** i in res,
                not last, n, n if cross else 0, _per_level(heads, i), _per_level(depth, i)))
            ch = chs[i]
            skip += [ch] * (n + (not last))
        self.mid_block = Block("mid", "mid_block", [ch, ch], ch, cfg,
                               cfg["use_motion_module"] and cfg["motion_module_mid_block"],
                               False, 2, 1, _per_level(heads, -1), _per_level(depth, -1))
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg["up_block_types"]):
            level = levels - 1 - i
            cout, in_chs = chs[level], []
            for _ in range(n + 1):
                in_chs.append(ch + skip.pop())
                ch = cout
            cross = kind == "CrossAttnUpBlock3D"
            self.up_blocks.append(Block(
                "up", f"up_blocks.{i}", in_chs, cout, cfg, 2 ** level in res, i < levels - 1,
                n + 1, n + 1 if cross else 0, _per_level(heads, level),
                _per_level(depth, level)))
        self.conv_norm_out = nn.GroupNorm(cfg["norm_num_groups"], ch0, eps=cfg["norm_eps"])
        self.conv_out = conv3(ch0, cfg["out_channels"])

    def set_recompute(self, on: bool) -> None:
        for m in self.modules():
            if isinstance(m, (ResnetBlock3D, VanillaTemporalModule, Transformer3DModel)):
                m.recompute = on

    def forward(self, sample, t: int, cond: Tuple, guidance=(), residuals=None,
                max_up_block=None, grad_cut=None):
        """``cond``: (context (B, T, 2048), pooled (B, 1280), time ids (B,
        6)); otherwise ``nets.UNet3D``'s."""
        context, pooled, time_ids = cond
        probs: Dict[str, torch.Tensor] = {}
        b = sample.shape[0]
        ch0 = self.cfg["block_out_channels"][0]
        temb = self.time_embedding(timestep_features(
            torch.full((b,), t, device=sample.device), ch0))
        ids = timestep_features(time_ids.reshape(-1), self.cfg["addition_time_embed_dim"])
        temb = temb + self.add_embedding(torch.cat([pooled, ids.reshape(b, -1)], dim=-1))
        x = conv(sample, self.conv_in)
        skips = [x]
        for block in self.down_blocks:
            x, s = block.down(x, temb, context, guidance, probs)
            skips += s
        x = self.mid_block.mid(x, temb, context, guidance, probs)
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


_ACTS = {"quick_gelu": lambda h: h * torch.sigmoid(1.702 * h), "gelu": F.gelu}


class CLIPLayer(nets.CLIPLayer):
    """``nets.CLIPLayer`` with the tower's activation (bigG's exact GELU)."""

    def __init__(self, d: int, heads: int, inner: int, eps: float, act: str):
        super().__init__(d, heads, inner, eps)
        self.act = _ACTS[act]

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
        return x + self.mlp.fc2(self.act(self.mlp.fc1(self.layer_norm2(x))))


class CLIPText(nn.Module):
    """Token ids (N, 77) -> (the penultimate hidden state (N, 77, hidden),
    with a ``projection_dim`` the projected pooled text (N, projection_dim),
    else None)."""

    def __init__(self, cfg: Mapping):
        super().__init__()
        if cfg["output_hidden_state"] != "penultimate":
            raise ValueError("the SDXL reference's towers give their penultimate state")
        d = cfg["hidden_size"]
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([
            CLIPLayer(d, cfg["num_heads"], cfg["intermediate_size"], cfg["layer_norm_eps"],
                      cfg["hidden_act"]) for _ in range(cfg["num_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=cfg["layer_norm_eps"])
        self.projected = cfg.get("projection_dim") is not None
        if self.projected:
            self.text_projection = nn.Linear(d, cfg["projection_dim"], bias=False)

    def forward(self, ids):
        tm = self.text_model
        s = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(
            torch.arange(s, device=ids.device))[None]
        mask = torch.full((s, s), float("-inf"), device=ids.device).triu(1)
        for layer in tm.encoder.layers[:-1]:
            x = layer(x, mask)
        if not self.projected:
            return x, None
        last = tm.final_layer_norm(tm.encoder.layers[-1](x, mask))
        eos = last[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)]
        return x, self.text_projection(eos)


def encode_text(nets_: Mapping[str, nn.Module], ids: Tuple[torch.Tensor, torch.Tensor]):
    """Both towers' ids -> (context (N, 77, 768 + 1280), pooled (N, 1280))."""
    state_1, _ = nets_["text_encoder"](ids[0])
    state_2, pooled = nets_["text_encoder_2"](ids[1])
    return torch.cat([state_1, state_2], dim=-1), pooled


def build(config: Mapping, device="meta", dtype=torch.float32) -> Dict[str, nn.Module]:
    """The configuration's networks, with uninitialised parameters on
    ``device``: {"unet", "vae", "text_encoder", "text_encoder_2"}."""
    with torch.device("meta"), initialisers_off():
        nets_ = {"unet": UNet3D(config["unet"]), "vae": VAE(config["vae"]),
                 "text_encoder": CLIPText(config["text_encoder"]),
                 "text_encoder_2": CLIPText(config["text_encoder_2"])}
    if device != "meta":
        nets_ = {k: m.to_empty(device=device).to(dtype) for k, m in nets_.items()}
    return {k: m.eval().requires_grad_(False) for k, m in nets_.items()}
