"""Attention dispatch of the port.

Port of ``motionclone_tpu/ops/attention.py``.  Tensors are (B, S, heads*D)
in their natural layout, straight from the q/k/v projections.

* ``impl="flash"``: kernels 1 and 2 (ops/flash_attention.py), used for
  spatial self-attention at every resolution.  CUDA tensors launch the
  kernel, CPU tensors run its plain version.
* ``impl="plain"``: f32 logits and softmax in plain PyTorch, used for
  cross-attention (kv = 77 text tokens, XLA einsums in the JAX package).

:func:`attention_probs` gives the full probability maps, for the guidance
blocks' F x F temporal attention, where the probabilities are the product.
"""

from __future__ import annotations

from typing import Optional

import torch

from motionclone_tpu_torch.ops.flash_attention import flash_attention


def attention_probs(
    q: torch.Tensor, k: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Full attention probability maps in float32: q/k (batch, seq, heads,
    head_dim) -> (batch, heads, seq_q, seq_k), with an explicit softmax that
    autograd differentiates."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return torch.softmax(logits * scale, dim=-1)


def plain_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float
) -> torch.Tensor:
    """softmax(q k^T * scale) v per head over (B, S, heads*D) tensors: f32
    logits and softmax, probabilities cast to v's dtype for the product."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // heads
    probs = attention_probs(q.reshape(b, sq, heads, d), k.reshape(b, sk, heads, d), scale)
    vh = v.reshape(b, sk, heads, d)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), vh).reshape(b, sq, hd)


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, heads: int,
    scale: float, impl: str = "flash",
) -> torch.Tensor:
    """Multi-head attention over (B, S, heads*D) tensors; ``impl`` is
    "flash" or "plain"."""
    if impl == "flash":
        return flash_attention(q, k, v, heads=heads, scale=scale)
    if impl == "plain":
        return plain_attention(q, k, v, heads, scale)
    raise ValueError(f"unknown attention impl: {impl}")

