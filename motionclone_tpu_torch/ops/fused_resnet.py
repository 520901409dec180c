"""Fused ResnetBlock3D forward: kernel 8 of the port.

``csrc/fused_resnet.cu`` with its plain PyTorch version beside it.  Replaces
the Pallas TPU kernel ``fused_resnet_block`` of
``motionclone_tpu/ops/fused_resnet.py``:

    x -> GN1 -> SiLU -> conv3x3 + b1 + temb row -> GN2 -> SiLU -> conv3x3
      + b2 + shortcut(x)

with per-(batch·frame) GroupNorm statistics.  The TPU kernel keeps one frame
in VMEM and forms each 3x3 tap as a masked row shift; on the H100 each
convolution is an implicit GEMM over K = 9·Cin whose loader gathers the taps
and zero-fills the frame edges, reading GN + SiLU of its input written once
as bf16 (design note in the CUDA source).  Forward-only: the wrapper refuses
inputs that require grad.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the kernel
or raise.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F

from motionclone_tpu_torch.ops import fused_common as fc
from motionclone_tpu_torch.ops.build import check, ints, load_library, pointers

# the JAX package's routing budget (a TPU VMEM budget, kept so that the port
# fuses exactly the blocks the JAX package fuses)
MAX_WEIGHT_BYTES = 48 * 1024 * 1024


class ResnetWeights(NamedTuple):
    """One ResnetBlock3D in the kernel's layout.  Conv weights are
    (Cout, 9·Cin) with column (dy·3 + dx)·Cin + ci: PyTorch's (Cout, Cin, 3,
    3) permuted to (Cout, 3, 3, Cin), i.e. the JAX kernel's (9·Cin, Cout)
    transposed."""

    gn1_scale: torch.Tensor
    gn1_bias: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    gn2_scale: torch.Tensor
    gn2_bias: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    wsc: Optional[torch.Tensor]  # (Cout, Cin) 1x1 shortcut, None if identity
    bsc: Optional[torch.Tensor]


def supported(x_shape, cout: int, groups: int, time_embedding_norm: str = "default",
              itemsize: int = 2) -> bool:
    """Copy of ``motionclone_tpu.ops.fused_resnet.supported``: whether the
    JAX package fuses this block (else the unfused path runs)."""
    if len(x_shape) != 5:
        return False
    _, _, h, w, cin = x_shape
    if time_embedding_norm != "default":
        return False
    if cin % groups or cout % groups:
        return False
    if cin % 8 or cout % 8 or w % 8 or h < 3 or w < 3:
        return False
    weight_bytes = (9 * cin * cout + 9 * cout * cout + cin * cout) * itemsize
    if weight_bytes > MAX_WEIGHT_BYTES:
        return False
    frame_bytes = (h * w + 2 * w + 16) * (cin + cout) * itemsize + h * w * cout * 4
    return frame_bytes < 24 * 1024 * 1024


def conv_weight(w: torch.Tensor) -> torch.Tensor:
    """PyTorch's (Cout, Cin, 3, 3) conv weight as the kernel's (Cout, 9·Cin)."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _gn_silu(x: torch.Tensor, groups: int, eps: float, scale, bias) -> torch.Tensor:
    """(N, H, W, C) -> per-sample GroupNorm -> SiLU, f32."""
    w, b = fc.group_norm_affine(x, groups, eps, scale, bias)
    return F.silu(x.float() * w[:, None, None, :] + b[:, None, None, :])


def _conv3x3(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, H, W, Cin) x the kernel-layout weight -> (N, H, W, Cout), f32."""
    cout = w.shape[0]
    wk = w.float().reshape(cout, 3, 3, -1).permute(0, 3, 1, 2)
    y = F.conv2d(a.float().permute(0, 3, 1, 2), wk, padding=1)
    return y.permute(0, 2, 3, 1)


def fused_resnet_block_plain(
    x: torch.Tensor, temb_out: Optional[torch.Tensor], w: ResnetWeights, *,
    groups: int, eps: float,
) -> torch.Tensor:
    """(B, F, H, W, Cin) -> (B, F, H, W, Cout) in x's dtype; f32 math with
    the kernel's rounding points (the convolutions read x's dtype, conv1's
    output stays f32)."""
    b, f, hh, ww, cin = x.shape
    cout = w.w1.shape[0]
    dt = x.dtype
    xr = x.reshape(b * f, hh, ww, cin)
    h = _conv3x3(_gn_silu(xr, groups, eps, w.gn1_scale, w.gn1_bias).to(dt), w.w1)
    h = h + w.b1.float()
    if temb_out is not None:
        t = temb_out.to(dt).float().repeat_interleave(f, dim=0)
        h = h + t[:, None, None, :]
    out = _conv3x3(_gn_silu(h, groups, eps, w.gn2_scale, w.gn2_bias).to(dt), w.w2)
    out = out + w.b2.float()
    sc = xr.float() if w.wsc is None else fc.linear(xr, w.wsc, w.bsc)
    return (out + sc).to(dt).reshape(b, f, hh, ww, cout)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def fused_resnet_kernel(
    x: torch.Tensor, temb_out: Optional[torch.Tensor], w: ResnetWeights, *,
    groups: int, eps: float,
) -> torch.Tensor:
    """Kernel 8 on CUDA bf16 tensors; weights as :class:`ResnetWeights`."""
    b, f, hh, ww, cin = x.shape
    cout = w.w1.shape[0]
    fc.check_cuda_inputs("fused_resnet_block", (x, temb_out), tuple(w))
    if w.w1.shape != (cout, 9 * cin) or w.w2.shape != (cout, 9 * cout):
        raise ValueError(f"fused_resnet_block: conv weights {tuple(w.w1.shape)}, "
                         f"{tuple(w.w2.shape)} do not fit x {tuple(x.shape)}")
    if temb_out is not None and temb_out.shape != (b, cout):
        raise ValueError(f"fused_resnet_block: temb {tuple(temb_out.shape)} != {(b, cout)}")
    bf, hw, cmax = b * f, hh * ww, max(cin, cout)
    nch = fc.gn_chunks(hw)
    f32 = dict(device=x.device, dtype=torch.float32)
    part = torch.empty(bf * nch * 2 * cmax, **f32)
    gw, gb = torch.empty(bf * cmax, **f32), torch.empty(bf * cmax, **f32)
    h = torch.empty(bf * hw * cout, **f32)
    sc = None if w.wsc is None else torch.empty(bf * hw * cout, **f32)
    act = torch.empty(bf * hw * cmax, device=x.device, dtype=torch.bfloat16)
    out = torch.empty((b, f, hh, ww, cout), device=x.device, dtype=torch.bfloat16)
    lib = load_library()
    with torch.cuda.device(x.device):
        check(lib.mc_fused_resnet_block(
            pointers(x, temb_out, w.gn1_scale, w.gn1_bias, w.w1, w.b1,
                     w.gn2_scale, w.gn2_bias, w.w2, w.b2, w.wsc, w.bsc, out,
                     part, gw, gb, h, sc, act),
            ints(bf, f, hh, ww, cin, cout, groups, nch), float(eps),
            fc.stream_of(x),
        ), "fused_resnet_block")
    fused_resnet_kernel.launches += 1
    return out


fused_resnet_kernel.launches = 0


def fused_resnet_block(
    x: torch.Tensor, temb_out: Optional[torch.Tensor], w: ResnetWeights, *,
    groups: int, eps: float,
) -> torch.Tensor:
    """Forward of one ResnetBlock3D: the kernel for CUDA tensors, the plain
    version for CPU tensors.  ``temb_out`` is ``time_emb_proj(silu(temb))``
    (B, Cout) or None."""
    fc.check_no_grad("fused_resnet_block", (x, temb_out, *w))
    if x.device.type == "cpu":
        return fused_resnet_block_plain(x, temb_out, w, groups=groups, eps=eps)
    return fused_resnet_kernel(x, temb_out, w, groups=groups, eps=eps)
