"""The card's published peaks and the least time a kernel call can take.

Peaks: NVIDIA's H100 SXM data sheet, dense bf16 tensor-core rate and HBM3
bandwidth at the full 700 W power limit.  A call's bound is the larger of
its operations over the peak rate and its bytes over the peak bandwidth,
with each input byte read once and each output byte written once
(``chip_smoke.py``'s ``bound()`` and its kernel table's counts, taken
from the call's shapes).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

PEAK_BF16_FLOPS = 989e12  # per second
PEAK_BYTES = 3.35e12      # per second


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds a call of ``flops`` operations moving ``nbytes``
    bytes takes on the card."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def flash_fwd(q, k, heads: int) -> Tuple[float, float]:
    """Kernel 1, q (B, Sq, heads*D), k and v (B, Sk, heads*D): q, k, v read,
    out (bf16) and lse (f32) written."""
    b, sq, hd = q
    sk = k[1]
    return 4 * b * sq * sk * hd, (2 * b * sq * hd + 2 * b * sk * hd) * 2 + b * heads * sq * 4


def flash_bwd(q, k, heads: int) -> Tuple[float, float]:
    """Kernel 2: q, out, dout read and dq written (Sq rows), k, v read and
    dk, dv written (Sk rows), lse read."""
    b, sq, hd = q
    sk = k[1]
    return 10 * b * sq * sk * hd, (4 * b * sq * hd + 4 * b * sk * hd) * 2 + b * heads * sq * 4


def temporal_fwd(q, k, heads: int) -> Tuple[float, float]:
    """Kernel 3 (3r), q (B, Fq, S, heads*D), k and v (B, Fk, S, heads*D):
    q, k, v read, out and lse written."""
    b, fq, s, hd = q
    fk = k[1]
    return (4 * b * s * fq * fk * hd,
            (2 * b * fq * s * hd + 2 * b * fk * s * hd) * 2 + b * s * heads * fq * 4)


def temporal_bwd(q, k, heads: int) -> Tuple[float, float]:
    """Kernel 4 (4r): q, dout read and dq written (Fq frames), k, v read
    and dk, dv written (Fk frames), lse read."""
    b, fq, s, hd = q
    fk = k[1]
    return (10 * b * s * fq * fk * hd,
            (3 * b * fq * s * hd + 4 * b * fk * s * hd) * 2 + b * s * heads * fq * 4)


def spatial_transformer(x, ctx, blocks: int = 20) -> Tuple[float, float]:
    """Kernel 5 (``blocks`` = 20: GroupNorm, proj_in, the transformer block,
    proj_out) or kernel 6 (18: the block alone) over x (BF, S, C) with text
    (B, T, Dc): the C x C products, self-attention over S, cross-attention
    over T and the text's k/v projections; x read and out written, the
    text and the weights read."""
    bf, s, c = x
    b, t, dc = ctx
    mm = 2 * bf * s * c * c
    attn = 4 * bf * s * s * c + 4 * bf * s * t * c + 4 * b * t * dc * c
    return blocks * mm + attn, 2 * 2 * bf * s * c + 2 * b * t * dc + 2 * (20 * c * c + 2 * dc * c)


def temporal_module(x, n_attn: int) -> Tuple[float, float]:
    """Kernel 7 over x (B, F, S, C) with ``n_attn`` attention blocks:
    proj_in, q/k/v/out per block, the GEGLU feed-forward, proj_out, and
    attention over F frames per pixel; x read, out written, weights read."""
    b, f, s, c = x
    rows = b * f * s
    return ((28 + 8 * n_attn) * rows * c * c + n_attn * 4 * b * s * f * f * c,
            2 * 2 * rows * c + 2 * (14 + 4 * n_attn) * c * c)


def resnet_block(x, cout: int) -> Tuple[float, float]:
    """Kernel 8 over x (B, F, H, W, Cin): two 3x3 convolutions and the 1x1
    shortcut where the width changes; x read, out written, weights and the
    time embedding read."""
    b, f, h, w, cin = x
    pix = b * f * h * w
    macs = 9 * cin * cout + 9 * cout * cout + (cin * cout if cin != cout else 0)
    return 2 * pix * macs, 2 * pix * (cin + cout) + 2 * macs + 2 * b * cout


# the port's kernel entry points (module under ``motionclone_tpu_torch.ops``,
# function) -> (layer, a function of the call's arguments -> (flops, bytes))
def _shape(t):
    return tuple(t.shape)


KERNELS: Dict[Tuple[str, str], Tuple[str, Callable]] = {
    ("flash_attention", "flash_fwd"):
        ("attention", lambda q, k, v, heads, scale: flash_fwd(_shape(q), _shape(k), heads)),
    ("flash_attention", "flash_bwd"):
        ("attention", lambda q, k, v, out, lse, dout, heads, scale:
         flash_bwd(_shape(q), _shape(k), heads)),
    ("temporal_attention", "temporal_fwd"):
        ("attention", lambda q, k, v, heads, scale: temporal_fwd(_shape(q), _shape(k), heads)),
    ("temporal_attention", "temporal_fwd_rect"):
        ("attention", lambda q, k, v, heads, scale: temporal_fwd(_shape(q), _shape(k), heads)),
    ("temporal_attention", "temporal_bwd"):
        ("attention", lambda q, k, v, lse, dout, heads, scale:
         temporal_bwd(_shape(q), _shape(k), heads)),
    ("temporal_attention", "temporal_bwd_rect"):
        ("attention", lambda q, k, v, lse, dout, heads, scale:
         temporal_bwd(_shape(q), _shape(k), heads)),
    ("fused_block", "fused_spatial_transformer_kernel"):
        ("fused", lambda x, ctx, w, **kw: spatial_transformer(_shape(x), _shape(ctx), 20)),
    ("fused_block", "fused_transformer_block_kernel"):
        ("fused", lambda x, ctx, w, **kw: spatial_transformer(_shape(x), _shape(ctx), 18)),
    ("fused_temporal", "fused_temporal_kernel"):
        ("fused", lambda x, w, **kw: temporal_module(_shape(x), len(w.attn))),
    ("fused_resnet", "fused_resnet_kernel"):
        ("fused", lambda x, temb_out, w, **kw: resnet_block(_shape(x), w.w1.shape[0])),
}
