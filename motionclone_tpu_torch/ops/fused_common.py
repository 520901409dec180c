"""Python side shared by the fused forward modules (kernels 5-8).

Mirrors ``csrc/fused_common.cuh``: the plain PyTorch versions of the
normalisations and products the fused kernels apply (with the kernels'
rounding points, so a bf16 kernel can be held against them), the checks
every fused wrapper makes before a launch, and the cache that keeps a
module's weights in the kernels' layout.

The layouts the kernels read, shared by the plain versions:

* a product's weight is ``nn.Linear``'s (out, in), bf16 on the card;
* q, k and v projections are stacked on the out axis: (3C, C), and the
  cross-attention's k and v (2C, Dc);
* GEGLU's projection has its value and gate rows interleaved, row 2j the
  value and row 2j + 1 the gate of hidden unit j (bias likewise), so one
  thread of the kernel's epilogue holds both;
* vectors (biases, norm scales and shifts) are f32.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, TypeVar

import torch
from torch.nn import functional as F

T = TypeVar("T")

LN_EPS = 1e-5


def gn_chunks(s: int) -> int:
    """Pixel chunks per frame of the GroupNorm statistics' first pass (the
    kernel's partial-sum scratch holds BF * chunks * 2 * C floats)."""
    return max(1, min(64, s // 64))


# ---------------------------------------------------------------------------
# plain versions of the kernels' pieces (f32 math)
# ---------------------------------------------------------------------------


def group_norm_affine(
    x: torch.Tensor, groups: int, eps: float, scale: torch.Tensor,
    bias: torch.Tensor,
) -> tuple:
    """GroupNorm of x (N, ..., C) per sample, folded to the per-(sample,
    channel) affine (w, b), both (N, C) f32: normalise(x) = x * w + b."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3))
    var = (xf.square().mean(dim=(1, 3)) - mean.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    w = rstd.repeat_interleave(c // groups, dim=1) * scale.float()
    b = bias.float() - mean.repeat_interleave(c // groups, dim=1) * w
    return w, b


def layer_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (eps 1e-5, variance as
    E[x^2] - E[x]^2 clamped at 0, as the kernels form it)."""
    hf = h.float()
    mean = hf.mean(dim=-1, keepdim=True)
    var = (hf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
    return (hf - mean) * torch.rsqrt(var + LN_EPS) * scale.float() + bias.float()


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w^T (+ b) in f32, whatever the operands' dtype."""
    return F.linear(x.float(), w.float(), None if b is None else b.float())


def geglu(hp: torch.Tensor) -> torch.Tensor:
    """value * gelu_erf(gate) of an interleaved (value, gate) projection."""
    return hp[..., 0::2] * F.gelu(hp[..., 1::2])


# ---------------------------------------------------------------------------
# weights in the kernels' layout
# ---------------------------------------------------------------------------


def interleave_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rows a0, b0, a1, b1, ... of two equal-shape tensors (GEGLU's value
    and gate halves)."""
    return torch.stack([a, b], dim=1).reshape(2 * a.shape[0], *a.shape[1:])


def geglu_weights(proj: torch.nn.Linear, dtype: torch.dtype) -> tuple:
    """A diffusers GEGLU projection (value rows first, gate rows second) as
    the kernels' interleaved (weight, bias)."""
    w, b = proj.weight.chunk(2, dim=0), proj.bias.chunk(2, dim=0)
    return interleave_rows(*w).to(dtype), interleave_rows(*b).float()


def cached_pack(module: torch.nn.Module, dtype: torch.dtype, build: Callable[[], T]) -> T:
    """``build()`` under no_grad, cached on ``module`` until a parameter is
    replaced, moved or changed in place (the key holds each parameter's
    storage pointer and version counter) or another dtype is asked for."""
    key = (dtype,) + tuple((p.data_ptr(), p._version) for p in module.parameters())
    hit = module.__dict__.get("_fused_pack")
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        packed = _detached(build())
    module.__dict__["_fused_pack"] = (key, packed)
    return packed


def _detached(obj):
    """``obj`` (tensors in nested NamedTuples and tuples) with every tensor
    detached: a packed f32 vector may be the parameter itself."""
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if isinstance(obj, tuple):
        vals = [_detached(v) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj


# ---------------------------------------------------------------------------
# wrapper checks
# ---------------------------------------------------------------------------


def check_no_grad(name: str, tensors: Sequence[Optional[torch.Tensor]]) -> None:
    """The fused kernels are forward-only: refuse inputs autograd tracks."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name} is forward-only: run it under torch.no_grad() (an input "
            f"requires grad)"
        )


def check_cuda_inputs(name: str, activations: Sequence[Optional[torch.Tensor]],
                      weights: Sequence[Optional[torch.Tensor]]) -> None:
    """bf16 contiguous activations and matrices, f32 vectors, all on one
    CUDA device and 16-byte aligned."""
    dev = activations[0].device
    for t in (*activations, *weights):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")
    for t in activations:
        if t is not None and t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16 activations, got {t.dtype}")
    for t in weights:
        if t is None:
            continue
        want = torch.bfloat16 if t.dim() >= 2 else torch.float32
        if t.dtype != want:
            raise ValueError(
                f"{name}: weight of shape {tuple(t.shape)} must be {want}, got {t.dtype}"
            )


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
