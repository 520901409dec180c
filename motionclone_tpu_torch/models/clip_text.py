"""CLIP text encoders: ViT-L/14's (SD1.5, SDXL) and OpenCLIP ViT-bigG/14's
(SDXL's second tower).

Port of ``motionclone_tpu/models/clip_text.py``: a causal transformer with
quick-GELU MLPs and a final LayerNorm, returning the last hidden state
(B, 77, 768), the UNet's cross-attention context.  A tower configured with
``output_hidden_state="penultimate"`` returns instead the hidden state
before its last layer, with no final LayerNorm (SDXL's
``hidden_states[-2]``); one with a ``projection_dim`` also gives, through
:meth:`CLIPTextModel.encode`, the pooled text: the final-LayerNorm state at
the EOS position (the largest id of each row) through ``text_projection``
(no bias).  Submodule names follow the
Hugging Face ``CLIPTextModel`` keys (``text_model.encoder.layers.N.
self_attn.q_proj`` ...).  Attention over 77 tokens is plain PyTorch with f32
logits and softmax; LayerNorms compute in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from motionclone_tpu_torch.models.layers import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    # transformers ``hidden_act``: SD1.5's tower uses quick_gelu
    hidden_act: str = "quick_gelu"
    # "last" (after the final LayerNorm) or "penultimate" (before the last layer)
    output_hidden_state: str = "last"
    projection_dim: Optional[int] = None  # the pooled text's projection (bigG)

    def __post_init__(self):
        if self.hidden_act not in _ACTIVATIONS:
            raise ValueError(
                f"unsupported CLIP hidden_act {self.hidden_act!r}; "
                f"supported: {sorted(_ACTIVATIONS)}"
            )
        if self.output_hidden_state not in ("last", "penultimate"):
            raise ValueError(f"output_hidden_state {self.output_hidden_state!r}: "
                             "last or penultimate")


def tiny_clip_config() -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
        intermediate_size=32, max_position_embeddings=77,
    )


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_ACTIVATIONS = {
    "quick_gelu": quick_gelu,
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
}


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.heads
        q = (self.q_proj(x) * hd**-0.5).reshape(b, s, self.heads, hd)
        k = self.k_proj(x).reshape(b, s, self.heads, hd)
        v = self.v_proj(x).reshape(b, s, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + causal_mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _ACTIVATIONS[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size
        )

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, penultimate: bool = False,
                pooled: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the last hidden state after the final LayerNorm, or with
        ``penultimate`` the state before the last layer; with ``pooled``
        the final-LayerNorm state at each row's EOS, the largest id, else
        None)."""
        x = self.embeddings(input_ids)
        s = input_ids.shape[1]
        causal_mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
        layers = self.encoder.layers
        for layer in layers[:-1]:
            x = layer(x, causal_mask)
        state = x
        if not penultimate or pooled:
            x = self.final_layer_norm(layers[-1](x, causal_mask))
            state = state if penultimate else x
        eos = None
        if pooled:
            eos = x[torch.arange(x.shape[0], device=x.device), input_ids.argmax(dim=-1)]
        return state, eos


class CLIPTextModel(nn.Module):
    """Token ids (B, 77) -> the configured hidden state (B, 77, hidden)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def encode(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the configured hidden state, the projected pooled text (B,
        projection_dim) or None without a projection)."""
        proj = self.cfg.projection_dim is not None
        state, eos = self.text_model(
            input_ids, penultimate=self.cfg.output_hidden_state == "penultimate", pooled=proj)
        return state, (self.text_projection(eos) if proj else None)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.encode(input_ids)[0]
