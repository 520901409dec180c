"""Python side shared by the fused forward modules (kernels 5-8).

Mirrors ``csrc/fused_common.cuh`` and ``csrc/fused_product.cuh``: the plain
PyTorch versions of the normalisations and products the fused kernels apply
(with the kernels' rounding points, so a bf16 kernel can be held against
them), the checks every fused wrapper makes before a launch, the shapes the
TMA + wgmma product of kernels 5-8 takes (and the routing rule that sends a
module to its kernel only on those shapes), that product alone
(:func:`fused_product`, for checking and timing it apart from the modules),
and the cache that keeps a module's weights in the kernels' layout.

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

from typing import Callable, Iterable, NamedTuple, Optional, Sequence, TypeVar

import torch
from torch.nn import functional as F

from motionclone_tpu_torch.ops.build import check, ints, load_library, pointers

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


def product_plain(
    a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
    res: Optional[torch.Tensor] = None, *, geglu_out: bool = False,
    out_dtype: torch.dtype = torch.bfloat16, split: int = 0,
) -> torch.Tensor:
    """The fused product with its epilogue, in f32 with one rounding to
    ``out_dtype``: a (M, K) @ w (N, K)^T + bias, then GEGLU of the
    interleaved columns (M, N / 2), or + res; with ``split``, the N columns
    as N / split contiguous (M, split) chunks, (N / split, M, split)."""
    y = linear(a, w, bias)
    if geglu_out:
        y = geglu(y)
    if res is not None:
        y = y + res.float()
    y = y.to(out_dtype)
    return torch.stack(y.split(split, dim=-1)) if split else y


# ---------------------------------------------------------------------------
# the shapes the product of kernels 5-8 takes (csrc/fused_product.cuh)
# ---------------------------------------------------------------------------

PRODUCT_BK = 64   # k-tile: one 128-byte swizzle row of bf16
PRODUCT_BN = 160  # tile width: every N and q|k|v chunk width at SD1.5 widths


class Product(NamedTuple):
    """One launch of the product inside a fused module: (M, N, K) and its
    epilogue, as the module's CUDA source launches it."""

    label: str
    m: int
    n: int
    k: int
    bias: bool = False
    res: Optional[str] = None   # residual dtype, "bf16" or "f32"
    out: str = "bf16"
    geglu: bool = False         # output (M, N / 2)
    split: int = 0              # chunk width of a split store, 0 for none
    inplace: bool = False       # the residual is the output (the f32 stream)


def product_takes(p: Product) -> bool:
    """Whether the TMA + wgmma product takes ``p``: K a multiple of 64, N
    and a split store's chunk width multiples of 160."""
    return not (p.m < 1 or p.k % PRODUCT_BK or p.n % PRODUCT_BN
                or (p.split and p.split % PRODUCT_BN))


def check_product(name: str, p: Product) -> None:
    """Raise ValueError unless the TMA + wgmma product takes ``p``."""
    if not product_takes(p):
        chunk = f" in chunks of {p.split}" if p.split else ""
        raise ValueError(
            f"{name}: its {p.label} product (M, N, K) = ({p.m}, {p.n}, {p.k}){chunk} "
            f"is not a shape the TMA + wgmma product takes (K % {PRODUCT_BK} == 0, "
            f"N and the chunk width % {PRODUCT_BN} == 0)"
        )


def check_products(name: str, products: Iterable[Product]) -> None:
    for p in products:
        check_product(name, p)


def takes_kernel(device_type: str, supported: bool,
                 device_supported: Callable[[], bool]) -> bool:
    """The fused route of a module on ``device_type``: the JAX package's
    predicate ``supported`` (on the CPU, where the kernel's plain version
    runs, that alone) and, on CUDA, the kernel's own shape rule
    ``device_supported()`` as well, a pure function of the shapes.  On
    CUDA, a shape the JAX package fuses but the kernel does not take runs
    the unfused modules (with the port's attention kernels): a decision made
    on shapes before any launch.  The kernel wrappers still raise on such a
    shape."""
    return supported and (device_type != "cuda" or device_supported())


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


# ---------------------------------------------------------------------------
# the product alone
# ---------------------------------------------------------------------------


def product_pointers(a, w, bias, res, out, *, geglu_out: bool = False, split: int = 0):
    """The (pointer array, dims array) of ``mc_fused_product``."""
    return (pointers(a, w, bias, res, out),
            ints(a.shape[0], w.shape[0], a.shape[1],
                 int(res is not None and res.dtype == torch.float32),
                 int(out.dtype == torch.float32), int(geglu_out), split))


def fused_product(
    a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
    res: Optional[torch.Tensor] = None, *, geglu_out: bool = False,
    out_dtype: torch.dtype = torch.bfloat16, split: int = 0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The product of kernels 5-7 alone (arguments as :func:`product_plain`),
    into ``out`` if given (which may be ``res``: the in-place update of the
    motion module's f32 stream): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    m, k = a.shape
    n = w.shape[0]
    shape = (m, n // 2) if geglu_out else (n // split, m, split) if split else (m, n)
    if out is None:
        out = torch.empty(shape, device=a.device, dtype=out_dtype)
    elif tuple(out.shape) != shape or out.dtype != out_dtype:
        raise ValueError(f"fused_product: out must be {shape} {out_dtype}")
    if a.device.type == "cpu":
        return out.copy_(product_plain(a, w, bias, res, geglu_out=geglu_out,
                                       out_dtype=out_dtype, split=split))
    check_cuda_inputs("fused_product", (a,), (w, bias))
    for t in (res, out):
        if t is not None and (t.device != a.device or not t.is_contiguous()
                              or t.data_ptr() % 16 or t.dtype not in (torch.bfloat16, torch.float32)):
            raise ValueError("fused_product: res and out must be contiguous, 16-byte aligned "
                             "bf16 or f32 tensors on a's device")
    if w.shape[1] != k or (res is not None and (tuple(res.shape) != (m, n) or geglu_out)):
        raise ValueError(f"fused_product: a {tuple(a.shape)}, w {tuple(w.shape)} and res "
                         f"do not fit (GEGLU takes no residual)")
    check_product("fused_product", Product("", m, n, k, split=split))
    lib = load_library()
    with torch.cuda.device(a.device):
        check(lib.mc_fused_product(*product_pointers(a, w, bias, res, out,
                                                     geglu_out=geglu_out, split=split),
                                   stream_of(a)), "fused_product")
    fused_product.launches += 1
    return out


fused_product.launches = 0
