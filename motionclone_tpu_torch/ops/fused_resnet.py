"""Fused ResnetBlock3D forward: kernel 8 of the port.

``csrc/fused_resnet.cu`` with its plain PyTorch version beside it.  Replaces
the Pallas TPU kernel ``fused_resnet_block`` of
``motionclone_tpu/ops/fused_resnet.py``:

    x -> GN1 -> SiLU -> conv3x3 + b1 + temb row -> GN2 -> SiLU -> conv3x3
      + b2 + shortcut(x)

with per-(batch·frame) GroupNorm statistics.  The TPU kernel keeps one frame
in VMEM and forms each 3x3 tap as a masked row shift; on the H100 each
convolution is an implicit GEMM over K = 9·Cin on the TMA + wgmma product of
``csrc/fused_product.cuh``, whose producer loads each tap's A tile through a
4-D tensor map that zero-fills outside the frame (:func:`conv_a_tile`
emulates that addressing), reading GN + SiLU of its input written once as
bf16 (design note in the CUDA sources).  The kernel takes the shapes of
:func:`device_supported`; the wrapper refuses others before any launch.
The convolution alone is :func:`conv3x3`.  Forward-only: the wrapper refuses
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


CONV_BM = 128  # rows of the product's tile: one A box of whole image rows


def products(bf: int, h: int, w: int, cin: int, cout: int) -> list:
    """The products ``csrc/fused_resnet.cu`` launches for (BF, H, W, Cin)
    -> Cout, in order: conv1 (f32 out, + b1 + temb row), the 1x1 shortcut
    when Cin != Cout, conv2 (+ b2 + the residual)."""
    m, P = bf * h * w, fc.Product
    out = [P("conv1", m, cout, 9 * cin, bias=True, out="f32")]
    if cin != cout:
        out.append(P("shortcut", m, cout, cin, bias=True, out="f32"))
    return out + [P("conv2", m, cout, 9 * cout, bias=True,
                    res="bf16" if cin == cout else "f32")]


def conv_takes(h: int, w: int, cin: int) -> bool:
    """The convolution's own rule beside the product's (csrc/fused_resnet.cu
    ``conv_takes``): Cin % 64 == 0 (a k-tile never straddles two taps), H·W
    % 128 == 0 (a tile never straddles two frames), and min(W, 128) dividing
    both 128 and W (one A box is whole image rows)."""
    wb = min(w, CONV_BM)
    return (cin % fc.PRODUCT_BK == 0 and h >= 1 and w >= 1 and (h * w) % CONV_BM == 0
            and CONV_BM % wb == 0 and w % wb == 0)


def device_supported(x_shape, cout: int) -> bool:
    """Whether kernel 8 takes a (B, F, H, W, Cin) input with Cout output
    channels: both convolutions (:func:`conv_takes`) and every product of
    :func:`products` (``fused_common.product_takes``).  A pure function of
    the shapes; no device is needed."""
    if len(x_shape) != 5:
        return False
    b, f, h, w, cin = x_shape
    return (conv_takes(h, w, cin) and conv_takes(h, w, cout)
            and all(fc.product_takes(p) for p in products(max(1, b * f), h, w, cin, cout)))


def _check_conv(name: str, h: int, w: int, *inputs: int) -> None:
    """Raise ValueError unless :func:`conv_takes` holds for each convolution
    input width."""
    if not all(conv_takes(h, w, c) for c in inputs):
        raise ValueError(
            f"{name}: (H, W) = ({h}, {w}) with input channels {inputs} is not a shape "
            f"the TMA + wgmma convolution takes (input channels % {fc.PRODUCT_BK} == 0, "
            f"H·W % {CONV_BM} == 0, min(W, {CONV_BM}) dividing {CONV_BM} and W)")


def check_shapes(name: str, x_shape, cout: int) -> None:
    """Raise ValueError unless kernel 8 takes the shapes (:func:`device_supported`)."""
    b, f, h, w, cin = x_shape
    fc.check_products(name, products(b * f, h, w, cin, cout))
    _check_conv(name, h, w, cin, cout)


def conv_box(h: int, w: int, cin: int, m_tile: int, k_tile: int) -> tuple:
    """The 4-D box the convolution's producer loads for (m-tile, k-tile):
    its start (c0, x, y, frame) in the tensor map over (Cin, W, H, BF) and
    its extent (64, min(W, 128), 128 / min(W, 128), 1).  k-tiles run over
    the 9 taps (dy·3 + dx) outermost, then the channel tiles."""
    hw, wb = h * w, min(w, CONV_BM)
    m0 = m_tile * CONV_BM
    frame, p0 = divmod(m0, hw)
    y0, x0 = divmod(p0, w)
    tap, c_tile = divmod(k_tile, cin // fc.PRODUCT_BK)
    dy, dx = divmod(tap, 3)
    start = (c_tile * fc.PRODUCT_BK, x0 + dx - 1, y0 + dy - 1, frame)
    return start, (fc.PRODUCT_BK, wb, CONV_BM // wb, 1)


def conv_a_tile(act: torch.Tensor, m_tile: int, k_tile: int) -> torch.Tensor:
    """The (128, 64) A tile the producer's 4-D TMA load delivers for
    (m-tile, k-tile) of the (BF, H, W, Cin) video ``act``, unswizzled: row r
    is box element (x + r % Wb, y + r // Wb), zero outside the tensor (the
    convolution's padding).  The whole im2col matrix, assembled from these
    tiles, is the implicit GEMM's A."""
    bf, h, w, cin = act.shape
    (c0, x, y, frame), (bk, wb, hb, _) = conv_box(h, w, cin, m_tile, k_tile)
    tile = act.new_zeros(hb, wb, bk)
    ys = [i for i in range(hb) if 0 <= y + i < h]
    xs = [i for i in range(wb) if 0 <= x + i < w]
    if ys and xs and 0 <= frame < bf:
        tile[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = act[
            frame, y + ys[0]:y + ys[-1] + 1, x + xs[0]:x + xs[-1] + 1, c0:c0 + bk]
    return tile.reshape(hb * wb, bk)


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


def conv3x3_plain(
    act: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    temb: Optional[torch.Tensor] = None, res: Optional[torch.Tensor] = None, *,
    frames: int = 1, out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The convolution with its epilogue, f32 math, one rounding to
    ``out_dtype``: (BF, H, W, Cin) by the kernel-layout weight, + bias, then
    + the temb row (videos, Cout) of each frame's video (``frames`` frames
    per video) or + ``res`` (BF, H, W, Cout)."""
    y = _conv3x3(act, w) + bias.float()
    if temb is not None:
        y = y + temb.float().repeat_interleave(frames, dim=0)[:, None, None, :]
    if res is not None:
        y = y + res.float()
    return y.to(out_dtype)


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


def conv3x3(
    act: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    temb: Optional[torch.Tensor] = None, res: Optional[torch.Tensor] = None, *,
    frames: int = 1, out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Kernel 8's convolution alone (arguments as :func:`conv3x3_plain`; the
    kernel takes conv1's flavour, f32 out with an optional temb row, and
    conv2's, bf16 out with a residual): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if act.device.type == "cpu":
        return conv3x3_plain(act, w, bias, temb, res, frames=frames, out_dtype=out_dtype)
    bf, hh, ww, cin = act.shape
    cout = w.shape[0]
    fc.check_cuda_inputs("conv3x3", (act, temb), (w, bias))
    if w.shape[1] != 9 * cin or (res is not None and tuple(res.shape) != (bf, hh, ww, cout)):
        raise ValueError(f"conv3x3: act {tuple(act.shape)}, w {tuple(w.shape)} and res "
                         f"do not fit")
    if res is None and out_dtype != torch.float32 or res is not None and (
            out_dtype != torch.bfloat16 or temb is not None):
        raise ValueError("conv3x3: the kernel takes f32 out with no residual (conv1) or "
                         "bf16 out with a residual and no temb row (conv2)")
    if res is not None and (not res.is_contiguous() or res.device != act.device
                            or res.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError("conv3x3: res must be a contiguous bf16 or f32 tensor on act's device")
    fc.check_product("conv3x3", fc.Product("conv", bf * hh * ww, cout, 9 * cin))
    _check_conv("conv3x3", hh, ww, cin)
    out = torch.empty((bf, hh, ww, cout), device=act.device, dtype=out_dtype)
    lib = load_library()
    with torch.cuda.device(act.device):
        check(lib.mc_conv3x3(
            pointers(act, w, bias, temb, res, out),
            ints(bf, frames, hh, ww, cin, cout,
                 int(res is not None and res.dtype == torch.float32),
                 int(out_dtype == torch.float32)),
            fc.stream_of(act),
        ), "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


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
    check_shapes("fused_resnet_block", x.shape, cout)
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
