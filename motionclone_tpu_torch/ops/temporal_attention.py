"""Per-pixel temporal self-attention on the natural (B, F, S, heads*D) layout.

Kernels 3 and 4 of the port: ``csrc/temporal_attention.cu`` forward and
backward, joined by a ``torch.autograd.Function``, with their plain PyTorch
version beside them.

Replaces the Pallas TPU kernels of
``motionclone_tpu/ops/temporal_attention.py``: the forward ``_temporal_fwd``
(``_fwd_kernel``) and the VJP ``_temporal_bwd`` (``_bwd_kernel``), reached
from ``temporal_attention`` there.

The motion module runs thousands of tiny F x F attentions, one per pixel and
head.  On the H100 that is bound by memory (8 flops per byte at F=16), so the
kernels read q/k/v (and dO) once in their natural layout through shared
memory and write each output once; the 16x16 products run on the CUDA
cores in f32.  The TPU kernel's block-diagonal packing with a cross-pixel
mask exists only to fill a 128-wide MXU and is not carried over.  The saved
log-sum-exp has the port's layout (B, S, heads, F): one contiguous F-vector
per (pixel, head).  The backward recomputes P from it and forms
delta = sum_j P_ij dP_ij without re-reading the forward's output.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from motionclone_tpu_torch.ops.build import check, load_library

KERNEL_HEAD_DIMS = (40, 80, 160)
KERNEL_FRAMES = 16


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def temporal_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, F, S, heads*D) in q's dtype, lse (B, S, heads, F) f32);
    f32 math, differentiable by autograd."""
    b, f, s, hd = q.shape
    d = hd // heads
    qs = q.reshape(b, f, s, heads, d).float()
    ks = k.reshape(b, f, s, heads, d).float()
    vs = v.reshape(b, f, s, heads, d).float()
    logits = torch.einsum("bfshd,bgshd->bshfg", qs, ks) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bshfg,bgshd->bfshd", probs, vs).reshape(b, f, s, hd)
    return out.to(q.dtype), lse


def temporal_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the plain version for the cotangent ``dout``."""
    with torch.enable_grad():
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        out, _ = temporal_attention_plain(qq, kk, vv, heads, scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(name: str, heads: int, *tensors: torch.Tensor) -> int:
    shape = tensors[0].shape
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if t.shape != shape or t.dim() != 4:
            raise ValueError(
                f"{name}: expected equal (B, F, S, heads*D) shapes, got "
                f"{[tuple(x.shape) for x in tensors]}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")
    _, f, _, hd = shape
    if f != KERNEL_FRAMES:
        raise ValueError(f"{name}: the kernel takes {KERNEL_FRAMES} frames, got {f}")
    if hd % heads or hd // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{name}: head dim {hd}/{heads} has no kernel "
            f"(compiled: {KERNEL_HEAD_DIMS})"
        )
    return hd // heads


def temporal_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3: (out bf16 (B, F, S, heads*D), lse f32 (B, S, heads, F))."""
    d = _check_inputs("temporal_fwd", heads, q, k, v)
    b, f, s, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, s, heads, f), device=q.device, dtype=torch.float32)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.mc_temporal_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, f, s, heads, d, float(scale), stream,
        ), "temporal_fwd")
    temporal_fwd.launches += 1
    return out, lse


temporal_fwd.launches = 0


def temporal_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 4: (dq, dk, dv) bf16 from the forward's lse."""
    d = _check_inputs("temporal_bwd", heads, q, k, v, dout)
    b, f, s, _ = q.shape
    if lse.shape != (b, s, heads, f) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"temporal_bwd: bad lse {tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.mc_temporal_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, f, s, heads, d, float(scale), stream,
        ), "temporal_bwd")
    temporal_bwd.launches += 1
    return dq, dk, dv


temporal_bwd.launches = 0


class TemporalAttention(torch.autograd.Function):
    """Kernel 3 forward, kernel 4 backward; saves (q, k, v, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        out, lse = temporal_fwd(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = temporal_bwd(
            q, k, v, lse, dout.contiguous(), ctx.heads, ctx.scale
        )
        return dq, dk, dv, None, None


def temporal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, heads: int,
    scale: float,
) -> torch.Tensor:
    """Differentiable per-pixel temporal attention over (B, F, S, heads*D)
    tensors: the kernels for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return temporal_attention_plain(q, k, v, heads, scale)[0]
    return TemporalAttention.apply(q, k, v, heads, scale)
