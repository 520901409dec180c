"""Exact multi-head attention on the natural (B, S, heads*D) layout.

Kernels 1 and 2 of the port: ``csrc/flash_attention.cu`` forward and
backward, joined by a ``torch.autograd.Function``, with their plain PyTorch
version beside them.

Replaces the Pallas TPU kernels of ``motionclone_tpu/ops/flash_attention.py``:
the forward ``_flash_fwd`` (``_fwd_kernel``) / ``_flash_fwd_whole``
(``_fwd_whole_kernel``) and the VJP ``_flash_bwd`` (``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) / ``_flash_bwd_whole`` (``_bwd_whole_kernel``), all
reached from ``flash_attention`` there.

On the H100 the spatial self-attention at 64x64 latents does about 2000
flops per byte moved, so memory never bounds it, and its backward must
never materialise the (B, heads, S, S) probabilities: 8.6 GB in f32 per
layer at S=4096 and B*F=16.  What bounds it is the tensor cores and, at
head dim 40, the exponentials: one per score on the special-function unit,
about 0.55 ms at (16, 4096, 8, 40) against 0.35 ms of products.  The
forward keeps each tile of scores on chip with an exact online softmax
(running row maximum; no +-75 logit clamp as on the TPU) and saves only the
f32 row log-sum-exp (B, heads, S).  Both products run on Hopper's wgmma
(bf16, f32 accumulation), with K/V tiles streamed by cp.async through a
ring of shared-memory stages that four warpgroups share, each running its
softmax while the tensor cores work on its products.
The backward is two kernels with no atomics (two launches give the same
bits): dq (looping over key tiles, and forming delta = rowsum(dO * O)
first) and dk/dv (looping over query tiles), both recomputing P from the
log-sum-exp.  ``csrc/flash_attention.cu`` has the full design note.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from motionclone_tpu_torch.ops.build import check, check_extent, load_library

# head dims with a compiled kernel (SD1.5: 320/640/1280 channels, 8 heads;
# SDXL: 640/1280 channels, 10/20 heads)
KERNEL_HEAD_DIMS = (40, 64, 80, 160)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, Sq, heads*D) in q's dtype, lse (B, heads, Sq) f32).

    Logits, softmax and the probability-value product in f32, as the
    kernel accumulates; differentiable by autograd (which stores the full
    probabilities, so use it at small sizes)."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // heads
    qh = q.reshape(b, sq, heads, d).float()
    kh = k.reshape(b, sk, heads, d).float()
    vh = v.reshape(b, sk, heads, d).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, sq, hd)
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the plain version for the cotangent ``dout``."""
    with torch.enable_grad():
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        out, _ = flash_attention_plain(qq, kk, vv, heads, scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(name: str, heads: int, *tensors: torch.Tensor) -> int:
    check_extent(*tensors)
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: expected contiguous, 16-byte aligned (B, S, heads*D) "
                f"tensors, got shape {tuple(t.shape)}"
            )
    q, k = tensors[0], tensors[1]
    b, _, hd = q.shape
    if hd % heads or hd // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{name}: head dim {hd}/{heads} has no kernel "
            f"(compiled: {KERNEL_HEAD_DIMS})"
        )
    if k.shape[0] != b or k.shape[2] != hd or tensors[2].shape != k.shape:
        raise ValueError(
            f"{name}: k/v shapes {tuple(k.shape)}, {tuple(tensors[2].shape)} "
            f"do not match q {tuple(q.shape)}"
        )
    return hd // heads


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1: (out bf16 (B, Sq, heads*D), lse f32 (B, heads, Sq))."""
    d = _check_inputs("flash_fwd", heads, q, k, v)
    b, sq, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, sq), device=q.device, dtype=torch.float32)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.mc_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, heads, sq, k.shape[1], d, float(scale), stream,
        ), "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 2: (dq, dk, dv) bf16 from the forward's out and lse."""
    d = _check_inputs("flash_bwd", heads, q, k, v)
    _check_inputs("flash_bwd", heads, out, dout, dout)
    b, sq, hd = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("flash_bwd: out/dout must have q's shape")
    if lse.shape != (b, heads, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_bwd: bad lse {tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty_like(lse)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.mc_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b, heads, sq, k.shape[1], d,
            float(scale), stream,
        ), "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Kernel 1 forward, kernel 2 backward; saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        out, lse = flash_fwd(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(
            q, k, v, out, lse, dout.contiguous(), ctx.heads, ctx.scale
        )
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, heads: int,
    scale: float,
) -> torch.Tensor:
    """Differentiable exact attention over (B, S, heads*D) tensors: the
    kernels for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, heads, scale)[0]
    return FlashAttention.apply(q, k, v, heads, scale)
