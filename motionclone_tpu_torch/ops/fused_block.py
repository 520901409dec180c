"""Fused spatial transformer forward: kernels 5 and 6 of the port.

``csrc/fused_block.cu`` with the plain PyTorch versions beside it.  Replaces
the Pallas TPU kernels of ``motionclone_tpu/ops/fused_block.py``:

* kernel 5, ``fused_spatial_transformer``: a whole single-layer
  Transformer3DModel, x -> per-frame GN (statistics included) -> proj_in
  -> BasicTransformerBlock -> proj_out -> + x;
* kernel 6, ``fused_transformer_block``: the BasicTransformerBlock alone,
  x -> + attn1(LN1 x) -> + attn2(LN2 ., text) -> + GEGLU FF(LN3 .).

The frame's self-attention streams K/V tile by tile through the exact
flash forward of ``csrc/flash_attention.cuh``; the products run through the
TMA + wgmma product of ``csrc/fused_product.cuh`` (whose shape rule
:func:`products` and ``fused_common.check_products`` mirror: the models
route only shapes of :func:`device_supported` to the kernels on CUDA, and
the wrapper refuses other shapes before any launch), and the text keys and values are
projected once per video, not once per frame (design note in the CUDA
source).  Unlike the JAX functions, which take the text context repeated
per frame (BF, T, Dc), these take it once per video (B, T, Dc) with
``frames`` = F.  Forward-only: the wrapper refuses inputs that require
grad.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the kernel
or raise.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from motionclone_tpu_torch.ops import fused_common as fc
from motionclone_tpu_torch.ops.build import check, ints, load_library, pointers
from motionclone_tpu_torch.ops.flash_attention import flash_attention_plain

# the JAX package's routing constants (TPU tiling and VMEM budgets, kept so
# that the port fuses exactly the modules the JAX package fuses)
DEFAULT_BQ = 512
MAX_FUSED_CHANNELS = 640
GN_EPS = 1e-6


class BlockWeights(NamedTuple):
    """One BasicTransformerBlock in the kernel's layout."""

    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wqkv1: torch.Tensor  # (3C, C): attn1 to_q, to_k, to_v stacked
    wo1: torch.Tensor
    bo1: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    wq2: torch.Tensor
    wkv2: torch.Tensor  # (2C, Dc): attn2 to_k, to_v stacked
    wo2: torch.Tensor
    bo2: torch.Tensor
    ln3_scale: torch.Tensor
    ln3_bias: torch.Tensor
    wff1: torch.Tensor  # (8C, C), value/gate rows interleaved
    bff1: torch.Tensor
    wff2: torch.Tensor  # (C, 4C)
    bff2: torch.Tensor


class TransformerWeights(NamedTuple):
    """A single-layer Transformer3DModel: GN, the 1x1 proj_in / proj_out as
    (C, C) matrices, and its block."""

    gn_scale: torch.Tensor
    gn_bias: torch.Tensor
    win: torch.Tensor
    bin: torch.Tensor
    block: BlockWeights
    wout: torch.Tensor
    bout: torch.Tensor


def supported(s: int, c: int, heads: int, block_q: int = DEFAULT_BQ) -> bool:
    """Copy of ``motionclone_tpu.ops.fused_block.supported``."""
    if c % heads or (c // heads) % 8:
        return False
    if c > MAX_FUSED_CHANNELS:
        return False
    return s % min(block_q, s) == 0


def products(bf: int, s: int, c: int, videos: int, t: int, dc: int,
             whole: bool = True) -> list:
    """The products ``csrc/fused_block.cu`` launches for (BF, S, C) frames of
    ``videos`` videos with (T, Dc) text, in order (kernel 5; kernel 6
    without the GN / proj_in entry and the proj_out exit)."""
    m, P = bf * s, fc.Product
    out = [P("proj_in", m, c, c, bias=True)] if whole else []
    out += [
        P("q|k|v", m, 3 * c, c, split=c),
        P("attn1 out", m, c, c, bias=True, res="bf16"),
        P("q2", m, c, c),
        P("text k|v", videos * t, 2 * c, dc, split=c),
        P("attn2 out", m, c, c, bias=True, res="bf16"),
        P("GEGLU", m, 8 * c, c, bias=True, geglu=True),
        P("ff out", m, c, 4 * c, bias=True, res="bf16"),
    ]
    if whole:
        out.append(P("proj_out", m, c, c, bias=True, res="bf16"))
    return out


def device_supported(s: int, c: int, t: int, dc: int) -> bool:
    """Whether kernels 5 and 6 take (S, C) frames with (T, Dc) text: every
    product of :func:`products` passes ``fused_common.product_takes``.  A
    pure function of the shapes; no device is needed."""
    return all(fc.product_takes(p) for p in products(1, s, c, 1, t, dc))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def fused_transformer_block_plain(
    x: torch.Tensor, ctx: torch.Tensor, w: BlockWeights, *, heads: int,
    frames: int,
) -> torch.Tensor:
    """(BF, S, C) with text (BF / frames, T, Dc) -> (BF, S, C) in x's dtype;
    f32 math, every sublayer's output rounded to x's dtype (the kernel's
    rounding points)."""
    dt = x.dtype
    scale = (x.shape[-1] // heads) ** -0.5
    q, k, v = fc.linear(fc.layer_norm(x, w.ln1_scale, w.ln1_bias).to(dt),
                        w.wqkv1).to(dt).chunk(3, dim=-1)
    a = flash_attention_plain(q, k, v, heads, scale)[0]
    x1 = (x.float() + fc.linear(a, w.wo1, w.bo1)).to(dt)
    q2 = fc.linear(fc.layer_norm(x1, w.ln2_scale, w.ln2_bias).to(dt), w.wq2).to(dt)
    k2, v2 = fc.linear(ctx, w.wkv2).to(dt).repeat_interleave(frames, dim=0).chunk(2, dim=-1)
    a2 = flash_attention_plain(q2, k2, v2, heads, scale)[0]
    x2 = (x1.float() + fc.linear(a2, w.wo2, w.bo2)).to(dt)
    act = fc.geglu(fc.linear(fc.layer_norm(x2, w.ln3_scale, w.ln3_bias).to(dt),
                             w.wff1, w.bff1)).to(dt)
    return (x2.float() + fc.linear(act, w.wff2, w.bff2)).to(dt)


def fused_spatial_transformer_plain(
    x: torch.Tensor, ctx: torch.Tensor, w: TransformerWeights, *, heads: int,
    groups: int, frames: int, eps: float = GN_EPS,
) -> torch.Tensor:
    """(BF, S, C) with text (BF / frames, T, Dc) -> (BF, S, C) in x's
    dtype."""
    dt = x.dtype
    gw, gb = fc.group_norm_affine(x, groups, eps, w.gn_scale, w.gn_bias)
    xn = (x.float() * gw[:, None] + gb[:, None]).to(dt)
    h = fc.linear(xn, w.win, w.bin).to(dt)
    h = fused_transformer_block_plain(h, ctx, w.block, heads=heads, frames=frames)
    return (x.float() + fc.linear(h, w.wout, w.bout)).to(dt)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch(entry: str, x, ctx, w: BlockWeights, entry_w, exit_w, heads: int,
            groups: int, frames: int, eps: float) -> torch.Tensor:
    bf, s, c = x.shape
    b, t, dc = ctx.shape
    if bf != b * frames:
        raise ValueError(f"{entry}: {bf} frames of x for {b} videos of {frames}")
    if w.wqkv1.shape != (3 * c, c) or w.wkv2.shape != (2 * c, dc):
        raise ValueError(f"{entry}: weights do not fit x {tuple(x.shape)}, ctx {tuple(ctx.shape)}")
    whole = entry_w is not None
    fc.check_products(entry, products(bf, s, c, b, t, dc, whole))
    m = bf * s
    nch = fc.gn_chunks(s)
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    bf16 = dict(device=dev, dtype=torch.bfloat16)
    scratch = (
        torch.empty(bf * nch * 2 * c, **f32) if whole else None,  # partial sums
        torch.empty(bf * c, **f32) if whole else None,            # gn w
        torch.empty(bf * c, **f32) if whole else None,            # gn b
        torch.empty(m * c, **bf16) if whole else None,            # h
        torch.empty(m * c, **bf16),                               # normalised operand
        torch.empty(3 * m * c, **bf16),                           # q | k | v
        torch.empty(m * c, **bf16),                               # attention output
        torch.empty(m * c, **bf16),                               # x1
        torch.empty(2 * b * t * c, **bf16),                       # k2 | v2
        torch.empty(m * 4 * c, **bf16),                           # GEGLU activation
        torch.empty(bf * heads * s, **f32),                       # lse
    )
    out = torch.empty_like(x)
    ent = entry_w if whole else (None,) * 4
    ext = exit_w if whole else (None,) * 2
    lib = load_library()
    with torch.cuda.device(dev):
        check(getattr(lib, "mc_" + entry)(
            pointers(x, ctx, *ent, *w, *ext, out, *scratch),
            ints(bf, frames, s, c, heads, t, dc, groups, nch), float(eps),
            fc.stream_of(x),
        ), entry)
    return out


def fused_spatial_transformer_kernel(
    x: torch.Tensor, ctx: torch.Tensor, w: TransformerWeights, *, heads: int,
    groups: int, frames: int, eps: float = GN_EPS,
) -> torch.Tensor:
    """Kernel 5 on CUDA bf16 tensors."""
    fc.check_cuda_inputs("fused_spatial_transformer", (x, ctx),
                         (w.gn_scale, w.gn_bias, w.win, w.bin, *w.block, w.wout, w.bout))
    out = _launch("fused_spatial_transformer", x, ctx, w.block,
                  (w.gn_scale, w.gn_bias, w.win, w.bin), (w.wout, w.bout),
                  heads, groups, frames, eps)
    fused_spatial_transformer_kernel.launches += 1
    return out


fused_spatial_transformer_kernel.launches = 0


def fused_transformer_block_kernel(
    x: torch.Tensor, ctx: torch.Tensor, w: BlockWeights, *, heads: int,
    frames: int,
) -> torch.Tensor:
    """Kernel 6 on CUDA bf16 tensors."""
    fc.check_cuda_inputs("fused_transformer_block", (x, ctx), tuple(w))
    out = _launch("fused_transformer_block", x, ctx, w, None, None, heads, 1,
                  frames, 0.0)
    fused_transformer_block_kernel.launches += 1
    return out


fused_transformer_block_kernel.launches = 0


def fused_spatial_transformer(
    x: torch.Tensor, ctx: torch.Tensor, w: TransformerWeights, *, heads: int,
    groups: int, frames: int, eps: float = GN_EPS,
) -> torch.Tensor:
    """Forward of a whole single-layer Transformer3DModel over (BF, S, C)
    with text (B, T, Dc): the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fc.check_no_grad("fused_spatial_transformer", (x, ctx, *w[:4], *w.block, *w[5:]))
    if x.device.type == "cpu":
        return fused_spatial_transformer_plain(x, ctx, w, heads=heads, groups=groups,
                                               frames=frames, eps=eps)
    return fused_spatial_transformer_kernel(x, ctx, w, heads=heads, groups=groups,
                                            frames=frames, eps=eps)


def fused_transformer_block(
    x: torch.Tensor, ctx: torch.Tensor, w: BlockWeights, *, heads: int,
    frames: int,
) -> torch.Tensor:
    """Forward of one BasicTransformerBlock over (BF, S, C) with text
    (B, T, Dc): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    fc.check_no_grad("fused_transformer_block", (x, ctx, *w))
    if x.device.type == "cpu":
        return fused_transformer_block_plain(x, ctx, w, heads=heads, frames=frames)
    return fused_transformer_block_kernel(x, ctx, w, heads=heads, frames=frames)
