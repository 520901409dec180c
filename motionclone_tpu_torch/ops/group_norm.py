"""GroupNorm, then SiLU if asked, differentiable with respect to its input.

The kernel pair of ``csrc/group_norm.cu`` (forward and backward, joined by
a ``torch.autograd.Function``), with their plain PyTorch versions beside
them.  Replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA,
which fuses it.  The port's eager chain (``models/layers.py``
``group_norm_nhwc``, then ``F.silu``) runs about ten f32 kernels forward,
autograd's backward over it more, and keeps three f32 copies of the input
for that backward; the guided step's conditional pass differentiates every
GroupNorm before its cut.  Here the forward reads x twice and writes y
once, the backward reads x and dy twice and writes dx once, and the
Function saves x and the per-(sample, group) mean and rstd only
(``csrc/group_norm.cu`` has the design note).

Statistics are f32 per (sample, group): per frame for a video (B, F, H, W,
C) with ``per_frame`` (AnimateDiff's inflated GroupNorm), over the whole
sample otherwise.  Arithmetic as ``group_norm_nhwc``'s: variance E[x^2] -
E[x]^2 clamped at 0, eps inside the rsqrt, ``((x - mean) * rstd) * weight +
bias`` in f32 (the kernels fold rstd * weight first: within an f32 ulp),
then SiLU; the result in x's dtype (the kernels round once, after SiLU).

Dispatch: CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.nn import functional as F

from motionclone_tpu_torch.ops.build import check, ints, load_library, pointers
from motionclone_tpu_torch.ops.fused_common import stream_of

# the kernels' grid aims at this many blocks (4 a streaming multiprocessor of
# the H100's 132, and some to spare): a sample's pixels are cut into chunks
# of at least CHUNK_MIN_PIXELS
GRID_BLOCKS = 1024
CHUNK_MIN_PIXELS = 32
# a block holds the 8-channel lanes of one pixel: C / 8 <= 512 threads
MAX_CHANNELS = 4096


def chunks(n: int, s: int) -> int:
    """Pixel chunks a sample of the kernels' grid, for n samples of s
    pixels: enough blocks to fill the card, none under CHUNK_MIN_PIXELS
    pixels (the partial-sum scratch holds n * chunks * 2 * C floats)."""
    return max(1, min(s // CHUNK_MIN_PIXELS, -(-GRID_BLOCKS // n)))


def samples(shape, per_frame: bool) -> int:
    """The GroupNorm's samples (statistics are per sample and group) of a
    channels-last tensor: frames of a video with ``per_frame``, else the
    leading axis."""
    return shape[0] * shape[1] if len(shape) == 5 and per_frame else shape[0]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def group_norm_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
    eps: float, silu: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y in x's dtype and shape, stats (2, N, groups) f32: mean,
    then rstd) for x (N, ..., C), the same operations as
    ``models/layers.py`` ``group_norm_nhwc`` (then ``F.silu``)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.reshape(n, -1, groups, c // groups).float()
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    out = (xf - mean) * rstd
    out = (out.reshape(x.shape) * weight.float() + bias.float()).to(x.dtype)
    if silu:
        out = F.silu(out)
    return out, torch.stack([mean.reshape(n, groups), rstd.reshape(n, groups)])


def group_norm_bwd_plain(
    dy: torch.Tensor, x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
    bias: torch.Tensor, groups: int, silu: bool,
) -> torch.Tensor:
    """dx of :func:`group_norm_plain` for the cotangent dy, derived by hand
    and computed in f32 from x and the saved statistics, as the kernel does:
    dx = rstd * (g·w - mean(g·w) - x̂ · mean(g·w·x̂)) per (sample, group),
    with x̂ = (x - mean) * rstd and g = dy, times SiLU'(x̂·w + b) with
    ``silu``.  The weight and bias are constants."""
    n, c = x.shape[0], x.shape[-1]
    cg = c // groups
    mean, rstd = (s.reshape(n, 1, groups, 1) for s in stats)
    xhat = (x.reshape(n, -1, groups, cg).float() - mean) * rstd
    g = dy.reshape(n, -1, groups, cg).float()
    w = weight.float().reshape(groups, cg)
    if silu:
        z = xhat * w + bias.float().reshape(groups, cg)
        sig = torch.sigmoid(z)
        g = g * sig * (1.0 + z * (1.0 - sig))
    gw = g * w
    a = gw.mean(dim=(1, 3), keepdim=True)
    b = (gw * xhat).mean(dim=(1, 3), keepdim=True)
    return (rstd * (gw - a - xhat * b)).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           groups: int, *others: torch.Tensor) -> None:
    """x (N, S, C) bf16 or f32, contiguous and 16-byte aligned on a CUDA
    device, with ``others`` of its shape and dtype; weight and bias (C) f32
    there; C % 8 == 0, groups dividing C, C <= MAX_CHANNELS."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the kernel takes bfloat16 or float32, got {x.dtype}")
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty (N, S, C) tensor, got {tuple(x.shape)}")
    n, _, c = x.shape
    if c % 8 or groups < 1 or c % groups or c > MAX_CHANNELS or n > 65535:
        raise ValueError(
            f"{name}: no kernel for {n} samples of {c} channels in {groups} groups (the "
            f"kernels take C % 8 == 0, groups dividing C, C <= {MAX_CHANNELS}, N <= 65535)")
    for t in (x, *others):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: tensors of x's shape and dtype expected, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")
    for t in (weight, bias):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name}: weight and bias must be ({c},) float32 on x's device, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _dims(x: torch.Tensor, groups: int, silu: bool) -> Tuple[int, ...]:
    n, s, c = x.shape
    return n, s, c, groups, chunks(n, s), int(x.dtype == torch.float32), int(silu)


def group_norm_fwd(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
    eps: float, silu: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on x (N, S, C): (y in x's dtype, stats (2, N,
    groups) f32: mean, then rstd)."""
    _check("group_norm_fwd", x, weight, bias, groups)
    dims = _dims(x, groups, silu)
    n, _, c, _, nch = dims[:5]
    y = torch.empty_like(x)
    stats = torch.empty((2, n, groups), device=x.device, dtype=torch.float32)
    part = torch.empty(n * nch * 2 * c, device=x.device, dtype=torch.float32)
    lib = load_library()
    with torch.cuda.device(x.device):
        check(lib.mc_group_norm_fwd(pointers(x, weight, bias, y, stats, part), ints(*dims),
                                    float(eps), stream_of(x)), "group_norm_fwd")
    group_norm_fwd.launches += 1
    return y, stats


group_norm_fwd.launches = 0


def group_norm_bwd(
    dy: torch.Tensor, x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
    bias: torch.Tensor, groups: int, silu: bool,
) -> torch.Tensor:
    """The backward kernel: dx (x's shape and dtype) for the cotangent dy
    from x and the forward's stats."""
    _check("group_norm_bwd", x, weight, bias, groups, dy)
    dims = _dims(x, groups, silu)
    n, _, c, _, nch = dims[:5]
    if stats.shape != (2, n, groups) or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError(f"group_norm_bwd: bad stats {tuple(stats.shape)} {stats.dtype}")
    dx = torch.empty_like(x)
    part = torch.empty(n * nch * 2 * c, device=x.device, dtype=torch.float32)
    coef = torch.empty((n, groups, 2), device=x.device, dtype=torch.float32)
    lib = load_library()
    with torch.cuda.device(x.device):
        check(lib.mc_group_norm_bwd(pointers(x, dy, weight, bias, stats, dx, part, coef),
                                    ints(*dims), stream_of(x)), "group_norm_bwd")
    group_norm_bwd.launches += 1
    return dx


group_norm_bwd.launches = 0


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm (+ SiLU) of x (N, S, C): the kernels on CUDA, their plain
    versions elsewhere.  Saves x and the (2, N, groups) statistics, nothing
    of x's size in f32.  weight and bias are constants (f32, detached): the
    backward returns the gradient of x alone."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int, eps: float, silu: bool):
        fwd = group_norm_fwd if x.is_cuda else group_norm_plain
        y, stats = fwd(x, weight, bias, groups, eps, silu)
        ctx.save_for_backward(x, stats, weight, bias)
        ctx.groups, ctx.silu = groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, stats, weight, bias = ctx.saved_tensors
        bwd = group_norm_bwd if x.is_cuda else group_norm_bwd_plain
        dx = bwd(dy.to(x.dtype).contiguous(), x, stats, weight, bias, ctx.groups, ctx.silu)
        return dx, None, None, None, None, None


def group_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
    eps: float, *, silu: bool = False, per_frame: bool = True,
) -> torch.Tensor:
    """GroupNorm (then SiLU with ``silu``) of a channels-last tensor (N,
    ..., C), statistics per frame of a (B, F, H, W, C) video with
    ``per_frame``, per sample otherwise; differentiable with respect to x
    only.  ``weight`` and ``bias`` are handed in as constants: pass them
    detached, f32 (``models/layers.py`` ``GroupNorm`` keeps such a copy);
    no gradient reaches them.  The kernels for CUDA tensors, the plain
    versions for CPU tensors."""
    x3 = x.reshape(samples(x.shape, per_frame), -1, x.shape[-1])
    if not x3.is_contiguous() or x3.data_ptr() % 16:
        x3 = x3.clone(memory_format=torch.contiguous_format)
    if torch.is_grad_enabled() and x.requires_grad:
        y = GroupNormFunction.apply(x3, weight, bias, groups, eps, silu)
    else:  # no graph to record: spare the host the Function's overhead
        fwd = group_norm_fwd if x.is_cuda else group_norm_plain
        y = fwd(x3, weight, bias, groups, eps, silu)[0]
    return y.reshape(x.shape)
