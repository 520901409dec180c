"""Per-pixel temporal self-attention on the natural (B, F, S, heads*D) layout.

Kernels 3 and 4 (the square form: q, k and v carry the same 16 frames) and
3r and 4r (the rectangular form: q carries 8, 4, 2 or 1 frames, k and v
16) of the port: ``csrc/temporal_attention.cu`` forward and backward,
joined by a ``torch.autograd.Function``, with their plain PyTorch version
beside them.  The rectangular form is frame-sharded sampling's: each shard
attends with its local query frames to the keys and values gathered over
all shards (``models/motion_module.py``, ``parallel/frames.py``).

Replaces the Pallas TPU kernels of
``motionclone_tpu/ops/temporal_attention.py``: the forward ``_temporal_fwd``
(``_fwd_kernel``) and the VJP ``_temporal_bwd`` (``_bwd_kernel``), reached
from ``temporal_attention`` there, whose k/v may carry more frames than q.

The motion module runs thousands of tiny FQ x FK attentions, one per pixel
and head.  On the H100 that is bound by memory (8 flops per byte at
FQ = FK = 16).  The kernels stream tiles of (b, one pixel, 160 channels of
whole heads) through a per-warp ring of bulk asynchronous copies, run the
16 x 16 products on the tensor cores (``mma.sync``) and write each output
once; :func:`tile_plan` mirrors their tiles and row runs.  The TPU kernel's
block-diagonal packing with a cross-pixel mask exists only to fill a
128-wide MXU and is not carried over.  The forward rounds P to bf16 before
P @ V, as the TPU kernel does; the plain version rounds at the same point.
The saved log-sum-exp has the port's layout (B, S, heads, FQ): one
contiguous FQ-vector per (pixel, head).  The backward recomputes P from it
and forms delta = sum_j P_ij dP_ij without re-reading the forward's output.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.  There is no fallback from one to the other.  The square
and rectangular wrappers count their launches apart.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from motionclone_tpu_torch.ops.build import check, check_extent, load_library

KERNEL_HEAD_DIMS = (40, 80, 160)
KERNEL_FRAMES = 16  # k/v frames of both forms, q frames of the square form
RECT_QUERY_FRAMES = (8, 4, 2, 1)  # q frames of the rectangular form


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def temporal_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, FQ, S, heads*D), k and v (B, FK, S, heads*D) -> (out
    (B, FQ, S, heads*D) in q's dtype, lse (B, S, heads, FQ) f32); f32 math
    with the probabilities rounded to q's dtype before P @ V (the kernels'
    and the TPU kernel's rounding point; a no-op in f32), differentiable by
    autograd, whose gradient passes the rounding unchanged, so the backward
    stays in f32 math."""
    b, f, s, hd = q.shape
    fk = k.shape[1]
    d = hd // heads
    qs = q.reshape(b, f, s, heads, d).float()
    ks = k.reshape(b, fk, s, heads, d).float()
    vs = v.reshape(b, fk, s, heads, d).float()
    logits = torch.einsum("bfshd,bgshd->bshfg", qs, ks) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    probs = probs + (probs.to(q.dtype).float() - probs).detach()
    out = torch.einsum("bshfg,bgshd->bfshd", probs, vs).reshape(b, f, s, hd)
    return out.to(q.dtype), lse


def temporal_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the plain version for the cotangent ``dout``, each of
    its input's shape."""
    with torch.enable_grad():
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        out, _ = temporal_attention_plain(qq, kk, vv, heads, scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


# ---------------------------------------------------------------------------
# the kernels' tile plan (csrc/temporal_attention.cuh), mirrored on the CPU
# ---------------------------------------------------------------------------

TILE_CHANNELS = 160  # channels of a tile: 4 heads at D = 40, 2 at 80, 1 at 160
TILE_PIXELS = 1      # pixels of a tile
RING_STAGES = 2      # stages of a warp's ring
ROW_PITCH = 2 * TILE_CHANNELS + 16  # bytes between a tile's rows in shared memory
MAX_SMEM = 232448    # dynamic shared memory of a block


def warps_per_block(d: int, q_frames: int, backward: bool) -> int:
    """Warps of a block (``Plan::NW``): as many rings of the tile's rows
    (q, k, v and, backward, dO) and their barriers as shared memory holds,
    at most 16."""
    rows = (2 * q_frames if backward else q_frames) + 2 * KERNEL_FRAMES
    warp_bytes = RING_STAGES * (TILE_PIXELS * rows * ROW_PITCH + 8)
    return min(16, MAX_SMEM // warp_bytes)


def tile_plan(batch: int, q_frames: int, pixels: int, heads: int, d: int,
              backward: bool = False, sms: int = 132) -> Dict[str, object]:
    """The tiles of kernel 3/3r (forward) or 4/4r (backward) over q of
    (batch, q_frames, pixels, heads*d), as the kernel walks them.

    Returns numpy int64 arrays:
      ``tiles``  (T, 5): b, first pixel, pixel end, first channel, channel
                 end: the channels are ``TILE_CHANNELS // d`` whole heads
                 (fewer in a last slice);
      ``warp``, ``iteration`` (T,): the warp of the grid (block·NW + warp
                 in block) that takes the tile, and at which step of its walk;
      ``loads`` and ``stores``: tensor name -> (N, 6): tile, b, frame,
                 pixel, first channel, channel end: one bulk copy of a row
                 run each (loads q, k, v and, backward, dout; stores out,
                 or dq, dk, dv);
      ``lse``    (N, 5): tile, b, pixel, first head, head end: the FQ-vectors
                 of lse a tile writes (forward) or reads (backward);
      ``grid``   (blocks, warps per block).
    """
    fk = KERNEL_FRAMES
    hs = TILE_CHANNELS // d
    ns = -(-heads // hs)
    sg = -(-pixels // TILE_PIXELS)
    t = np.arange(batch * sg * ns, dtype=np.int64)
    sl, u = t % ns, t // ns
    b = u // sg
    s0 = (u % sg) * TILE_PIXELS
    s1 = np.minimum(s0 + TILE_PIXELS, pixels)
    h0 = sl * hs
    h1 = np.minimum(h0 + hs, heads)
    tiles = np.stack([b, s0, s1, h0 * d, h1 * d], axis=1)
    nw = warps_per_block(d, q_frames, backward)
    blocks = min(sms, -(-len(t) // nw))
    # (tile, pixel) pairs, then each pair's runs of a tensor's frames
    npix = s1 - s0
    tp = np.repeat(t, npix)
    px = np.repeat(s0, npix) + np.arange(len(tp)) - np.repeat(np.cumsum(npix) - npix, npix)

    def runs(frames: int) -> np.ndarray:
        n = len(tp)
        tile = np.repeat(tp, frames)
        frame = np.tile(np.arange(frames), n)
        return np.stack([tile, b[tile], frame, np.repeat(px, frames),
                         tiles[tile, 3], tiles[tile, 4]], axis=1)

    q_side = ("q", "dout") if backward else ("q",)
    loads = {name: runs(q_frames) for name in q_side}
    loads.update(k=runs(fk), v=runs(fk))
    stores = ({"dq": runs(q_frames), "dk": runs(fk), "dv": runs(fk)} if backward
              else {"out": runs(q_frames)})
    lse = np.stack([tp, b[tp], px, h0[tp], h1[tp]], axis=1)
    return dict(tiles=tiles, warp=t % (blocks * nw), iteration=t // (blocks * nw),
                loads=loads, stores=stores, lse=lse, grid=(blocks, nw))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(name: str, heads: int, rect: bool,
                  qs: Sequence[torch.Tensor], kvs: Sequence[torch.Tensor]) -> int:
    """Validate tensors of q's shape (q, dout) and of k's (k, v) for the
    square or the rectangular kernel; returns the head dim."""
    check_extent(*qs, *kvs)
    shape = qs[0].shape
    if len(shape) != 4 or any(t.shape != shape for t in qs) or any(
        t.shape != (shape[0], KERNEL_FRAMES, *shape[2:]) for t in kvs
    ):
        raise ValueError(
            f"{name}: expected q-like (B, FQ, S, heads*D) and k/v "
            f"(B, {KERNEL_FRAMES}, S, heads*D) shapes, got "
            f"{[tuple(x.shape) for x in (*qs, *kvs)]}"
        )
    _, f, _, hd = shape
    frames = RECT_QUERY_FRAMES if rect else (KERNEL_FRAMES,)
    if f not in frames:
        raise ValueError(f"{name}: the kernel takes {frames} query frames, got {f}")
    if hd % heads or hd // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{name}: head dim {hd}/{heads} has no kernel "
            f"(compiled: {KERNEL_HEAD_DIMS})"
        )
    for t in (*qs, *kvs):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")
    return hd // heads


def _fwd(name: str, rect: bool, q, k, v, heads: int, scale: float):
    d = _check_inputs(name, heads, rect, (q,), (k, v))
    b, f, s, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, s, heads, f), device=q.device, dtype=torch.float32)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.mc_temporal_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, f, k.shape[1], s, heads, d, float(scale), stream,
        ), name)
    return out, lse


def _bwd(name: str, rect: bool, q, k, v, lse, dout, heads: int, scale: float):
    d = _check_inputs(name, heads, rect, (q, dout), (k, v))
    b, f, s, _ = q.shape
    if lse.shape != (b, s, heads, f) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name}: bad lse {tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.mc_temporal_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, f, k.shape[1], s, heads, d, float(scale), stream,
        ), name)
    return dq, dk, dv


def temporal_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3: (out bf16 (B, 16, S, heads*D), lse f32 (B, S, heads, 16))
    for q, k, v of 16 frames."""
    out = _fwd("temporal_fwd", False, q, k, v, heads, scale)
    temporal_fwd.launches += 1
    return out


def temporal_fwd_rect(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3r: (out bf16 (B, FQ, S, heads*D), lse f32 (B, S, heads, FQ))
    for q of FQ in {8, 4, 2, 1} frames and k, v of 16."""
    out = _fwd("temporal_fwd_rect", True, q, k, v, heads, scale)
    temporal_fwd_rect.launches += 1
    return out


def temporal_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 4: (dq, dk, dv) bf16 from kernel 3's lse."""
    grads = _bwd("temporal_bwd", False, q, k, v, lse, dout, heads, scale)
    temporal_bwd.launches += 1
    return grads


def temporal_bwd_rect(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 4r: dq of q's shape, dk and dv of k's, bf16, from kernel 3r's
    lse."""
    grads = _bwd("temporal_bwd_rect", True, q, k, v, lse, dout, heads, scale)
    temporal_bwd_rect.launches += 1
    return grads


for _wrapper in (temporal_fwd, temporal_fwd_rect, temporal_bwd, temporal_bwd_rect):
    _wrapper.launches = 0


class TemporalAttention(torch.autograd.Function):
    """Kernel 3 (3r) forward, kernel 4 (4r) backward, by the frame counts;
    saves (q, k, v, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        ctx.rect = q.shape[1] != k.shape[1]
        out, lse = (temporal_fwd_rect if ctx.rect else temporal_fwd)(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        bwd = temporal_bwd_rect if ctx.rect else temporal_bwd
        dq, dk, dv = bwd(q, k, v, lse, dout.contiguous(), ctx.heads, ctx.scale)
        return dq, dk, dv, None, None


def temporal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, heads: int,
    scale: float,
) -> torch.Tensor:
    """Differentiable per-pixel temporal attention of q (B, FQ, S, heads*D)
    over k, v (B, FK, S, heads*D): the kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"k/v shape {tuple(k.shape)} incompatible with q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return temporal_attention_plain(q, k, v, heads, scale)[0]
    return TemporalAttention.apply(q, k, v, heads, scale)
