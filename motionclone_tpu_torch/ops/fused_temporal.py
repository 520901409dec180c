"""Fused AnimateDiff motion module forward: kernel 7 of the port.

``csrc/fused_temporal.cu`` with its plain PyTorch version beside it.
Replaces the Pallas TPU kernel ``fused_temporal_module`` of
``motionclone_tpu/ops/fused_temporal.py`` (and the XLA reduction
``folded_groupnorm_affine`` that feeds it):

    x -> GN affine -> proj_in -> [LN -> +PE -> q, k, v -> per-pixel
      attention -> out-proj -> +res] x n_attn -> LN -> GEGLU FF -> +res
      -> proj_out -> + x

on the natural (B, F, S, C) layout, with the residual stream in f32 as on
the TPU.  Each product is one launch of the TMA + wgmma product of
``csrc/fused_product.cuh`` (whose shape rule :func:`products` and
``fused_common.check_products`` mirror: the models route only shapes of
:func:`device_supported` to the kernel on CUDA, and the wrapper refuses
other shapes before any launch) and the attention is the temporal forward kernel of
``csrc/temporal_attention.cuh`` (design note in the CUDA source).
Forward-only: the wrapper refuses inputs that require grad.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the kernel
or raise.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from motionclone_tpu_torch.ops import fused_common as fc
from motionclone_tpu_torch.ops.build import check, ints, load_library, pointers
from motionclone_tpu_torch.ops.temporal_attention import temporal_attention_plain

# the JAX package's routing constants (TPU tiling and VMEM budgets, kept so
# that the port fuses exactly the modules the JAX package fuses)
TILE_SPATIAL = 16
MAX_CHANNELS = 640
GN_EPS = 1e-6


class AttnWeights(NamedTuple):
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    wqkv: torch.Tensor  # (3C, C): to_q, to_k, to_v stacked
    wo: torch.Tensor
    bo: torch.Tensor


class TemporalModuleWeights(NamedTuple):
    """One TemporalTransformer3D (one transformer block) in the kernel's
    layout.  The GroupNorm enters as its raw scale and bias: the kernel
    forms the per-(b, f) statistics itself."""

    gn_scale: torch.Tensor
    gn_bias: torch.Tensor
    pe: Optional[torch.Tensor]  # (max_len, C) positional encoding, or None
    win: torch.Tensor
    bin: torch.Tensor
    attn: Tuple[AttnWeights, ...]
    ffln_scale: torch.Tensor
    ffln_bias: torch.Tensor
    wff1: torch.Tensor  # (8C, C), value/gate rows interleaved
    bff1: torch.Tensor
    wff2: torch.Tensor  # (C, 4C)
    bff2: torch.Tensor
    wout: torch.Tensor
    bout: torch.Tensor


def supported(f: int, s: int, c: int, heads: int, ts: int = TILE_SPATIAL) -> bool:
    """Copy of ``motionclone_tpu.ops.fused_temporal.supported``."""
    if c > MAX_CHANNELS or c % heads or (c // heads) % 8:
        return False
    return s % ts == 0 and f * ts >= 128


def _weights(w: TemporalModuleWeights):
    """Every weight tensor but the positional encoding."""
    out = [w.gn_scale, w.gn_bias, w.win, w.bin, w.ffln_scale, w.ffln_bias,
           w.wff1, w.bff1, w.wff2, w.bff2, w.wout, w.bout]
    for a in w.attn:
        out.extend(a)
    return out


def products(b: int, f: int, s: int, c: int, n_attn: int = 2) -> list:
    """The products ``csrc/fused_temporal.cu`` launches for (B, F, S, C)
    with ``n_attn`` attention blocks, in order; the out-projections and the
    FF's second product update the f32 stream h in place."""
    m, P = b * f * s, fc.Product
    out = [P("proj_in", m, c, c, bias=True, out="f32")]
    for _ in range(n_attn):
        out += [P("q|k|v", m, 3 * c, c, split=c),
                P("attn out", m, c, c, bias=True, res="f32", out="f32", inplace=True)]
    return out + [
        P("GEGLU", m, 8 * c, c, bias=True, geglu=True),
        P("ff out", m, c, 4 * c, bias=True, res="f32", out="f32", inplace=True),
        P("proj_out", m, c, c, bias=True, res="bf16"),
    ]


# the widest row csrc/fused_common.cuh's LayerNorm holds (ln_rows_kernel:
# 32 lanes x 8 channels x kRowChunks = 4)
LN_MAX_CHANNELS = 1024


def device_supported(s: int, c: int, n_attn: int = 2) -> bool:
    """Whether kernel 7 takes S pixels of C channels with ``n_attn``
    attention blocks: C fits the LayerNorm's row (``LN_MAX_CHANNELS``) and
    every product of :func:`products` passes ``fused_common.product_takes``.
    A pure function of the shapes; no device is needed."""
    return c <= LN_MAX_CHANNELS and all(
        fc.product_takes(p) for p in products(1, 1, s, c, n_attn))


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def fused_temporal_module_plain(
    x: torch.Tensor, w: TemporalModuleWeights, *, heads: int, groups: int,
    eps: float = GN_EPS,
) -> torch.Tensor:
    """(B, F, S, C) -> (B, F, S, C) in x's dtype; f32 math, products read
    x's dtype, residual stream f32 (the kernel's rounding points)."""
    b, f, s, c = x.shape
    dt = x.dtype
    xf = x.float()
    gw, gb = fc.group_norm_affine(x.reshape(b * f, s, c), groups, eps,
                                  w.gn_scale, w.gn_bias)
    h0 = (xf.reshape(b * f, s, c) * gw[:, None] + gb[:, None]).to(dt)
    h = fc.linear(h0, w.win, w.bin).reshape(b, f, s, c)
    scale = (c // heads) ** -0.5
    for a in w.attn:
        hn = fc.layer_norm(h, a.ln_scale, a.ln_bias)
        if w.pe is not None:
            hn = hn + w.pe[:f].float()[None, :, None, :]
        q, k, v = fc.linear(hn.to(dt), a.wqkv).to(dt).chunk(3, dim=-1)
        out, _ = temporal_attention_plain(q, k, v, heads, scale)
        h = h + fc.linear(out, a.wo, a.bo)
    hn = fc.layer_norm(h, w.ffln_scale, w.ffln_bias).to(dt)
    act = fc.geglu(fc.linear(hn, w.wff1, w.bff1)).to(dt)
    h = h + fc.linear(act, w.wff2, w.bff2)
    return (xf + fc.linear(h.to(dt), w.wout, w.bout)).to(dt)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def fused_temporal_kernel(
    x: torch.Tensor, w: TemporalModuleWeights, *, heads: int, groups: int,
    eps: float = GN_EPS,
) -> torch.Tensor:
    """Kernel 7 on CUDA bf16 tensors; weights as
    :class:`TemporalModuleWeights`."""
    b, f, s, c = x.shape
    pe = None if w.pe is None else w.pe[:f]
    fc.check_cuda_inputs("fused_temporal_module", (x, pe), _weights(w))
    if w.win.shape != (c, c) or w.wff1.shape != (8 * c, c):
        raise ValueError(f"fused_temporal_module: weights do not fit x {tuple(x.shape)}")
    fc.check_products("fused_temporal_module", products(b, f, s, c, len(w.attn)))
    m = b * f * s
    nch = fc.gn_chunks(s)
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    bf16 = dict(device=dev, dtype=torch.bfloat16)
    scratch = (
        torch.empty(b * f * nch * 2 * c, **f32),  # partial sums
        torch.empty(b * f * c, **f32),            # gn w
        torch.empty(b * f * c, **f32),            # gn b
        torch.empty(m * c, **f32),                # residual stream h
        torch.empty(m * c, **bf16),               # normalised operand
        torch.empty(3 * m * c, **bf16),           # q | k | v
        torch.empty(m * c, **bf16),               # attention output
        torch.empty(m * 4 * c, **bf16),           # GEGLU activation
        torch.empty(m * heads, **f32),            # lse
    )
    out = torch.empty_like(x)
    attn = [t for a in w.attn for t in (a.ln_scale, a.ln_bias, a.wqkv, a.wo, a.bo)]
    lib = load_library()
    with torch.cuda.device(dev):
        check(lib.mc_fused_temporal_module(
            pointers(x, w.gn_scale, w.gn_bias, pe, w.win, w.bin, w.ffln_scale,
                     w.ffln_bias, w.wff1, w.bff1, w.wff2, w.bff2, w.wout, w.bout,
                     out, *scratch, *attn),
            ints(b, f, s, c, heads, groups, len(w.attn), nch), float(eps),
            fc.stream_of(x),
        ), "fused_temporal_module")
    fused_temporal_kernel.launches += 1
    return out


fused_temporal_kernel.launches = 0


def fused_temporal_module(
    x: torch.Tensor, w: TemporalModuleWeights, *, heads: int, groups: int,
    eps: float = GN_EPS,
) -> torch.Tensor:
    """Forward of one motion module over (B, F, S, C): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    fc.check_no_grad("fused_temporal_module", (x, w.pe, *_weights(w)))
    if w.pe is not None and x.shape[1] > w.pe.shape[0]:
        raise ValueError(
            f"video_length {x.shape[1]} exceeds the positional-encoding table "
            f"({w.pe.shape[0]} rows)"
        )
    if x.device.type == "cpu":
        return fused_temporal_module_plain(x, w, heads=heads, groups=groups, eps=eps)
    return fused_temporal_kernel(x, w, heads=heads, groups=groups, eps=eps)
