"""Time the design variants of the TMA + wgmma product of kernels 5-8 on one H100.

    python3 scripts/torch_product_variants.py

Builds ``scripts/torch_product_variants.cu`` (the variants, on the port's
own device code in ``csrc/fused_product.cuh``) with ``nvcc`` for ``sm_90a``
into ``build/``, then at main-path product shapes times each variant beside
the shipped product (``fused_common.fused_product``) and ``torch.matmul``,
and at main-path shapes of kernel 8's convolution its tile variants (128-
and 256-row tiles) beside the shipped convolution (``fused_resnet.conv3x3``)
and cuDNN's (``torch.nn.functional.conv2d``), with the largest difference
of each whole variant from the shipped kernel's output.  The head of the
``.cu`` file says what each variant changes.  Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (index, name, whole product?) in the order of the .cu file's conv_variant()
CONV_VARIANTS = [
    (0, "128-row tile, no epilogue", False), (1, "  loads alone", False),
    (2, "  register epilogue", True), (3, "256-row tile, no epilogue", False),
    (4, "  loads alone", False), (5, "  register epilogue", True),
]
# (frame side, Cin, Cout, B·F): conv1 of the largest resnet of each level
CONV_SHAPES = [(64, 320, 320, 16), (64, 960, 320, 16), (32, 1920, 640, 16),
               (32, 640, 640, 32), (16, 1280, 1280, 16)]
# conv2 of the resnets whose shortcut makes its residual f32
RES_SHAPES = [(64, 320, 320, 16), (16, 1280, 1280, 16), (16, 1280, 1280, 32)]
# (index, name, whole product?) in the order of the .cu file's variant()
VARIANTS = [
    (0, "64-row WG, 6 stages", True), (1, "  no epilogue", False),
    (2, "  no wgmma", False), (3, "  loads alone", False),
    (4, "  batched epilogue", True), (5, "128-row WG, 4 stages", True),
    (6, "  no epilogue", False), (7, "  loads alone", False),
    (8, "  batched epilogue", True), (9, "f32-staged epilogue, 5 st.", True),
    (10, "  no wgmma", False), (11, "staged, 128-row WG, 3 st.", True),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_product_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from motionclone_tpu_torch.ops import build as kb
    from motionclone_tpu_torch.ops import fused_common as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    lib = kb.load_library()
    so = kb.BUILD_DIR / "libtorch_product_variants.so"
    out = subprocess.run(
        [kb._nvcc(), *kb.NVCC_FLAGS, "-shared", "-o", str(so),
         str(ROOT / "scripts" / "torch_product_variants.cu")],
        capture_output=True, text=True)
    print("\n".join(l for l in (out.stdout + out.stderr).splitlines()
                    if "registers" in l or "spill" in l and " 0 bytes spill" not in l))
    if out.returncode:
        print(out.stdout[-4000:], out.stderr[-4000:])
        return 1
    vlib = ctypes.CDLL(str(so))
    for fn in (vlib.mc_var, vlib.mc_var_conv):
        fn.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
        fn.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    dt = {"bf16": bf16, "f32": f32}
    wanted = {("q2", 320), ("attn1 out", 320), ("attn out", 320), ("GEGLU", 320),
              ("ff out", 320), ("q|k|v", 320), ("GEGLU", 640), ("ff out", 640)}
    shapes = [p for p in cs.main_path_products()
              if p.m in (65536, 16384) and (p.label, p.k if p.label != "ff out" else p.k // 4)
              in wanted]
    for p in shapes:
        a = torch.randn(p.m, p.k, generator=gen, device=dev).to(bf16)
        w = (torch.randn(p.n, p.k, generator=gen, device=dev) * p.k ** -0.5).to(bf16)
        bias = 0.1 * torch.randn(p.n, generator=gen, device=dev) if p.bias else None
        res = torch.randn(p.m, p.n, generator=gen, device=dev).to(dt[p.res]) if p.res else None
        kw = dict(geglu_out=p.geglu, out_dtype=dt[p.out], split=p.split)
        want = fc.fused_product(a, w, bias, None if res is None else res.clone(),
                                out=None if not p.inplace else res.clone(), **kw)
        work = None if res is None else res.clone()
        flops = 2 * p.m * p.n * p.k
        print(f"shape {p.label} (M, N, K)=({p.m}, {p.n}, {p.k}) res={p.res} "
              f"inplace={p.inplace} out={p.out}", flush=True)

        def row(name, ms, err=None):
            e = "" if err is None else f" max_diff_vs_shipped={err:.3e}"
            print(f"  {name:28s} {ms:.4f} ms {flops / ms / 1e9:7.1f} TFLOP/s{e}", flush=True)

        row("shipped fused_product", cs.time_ms(
            lambda: fc.fused_product(a, w, bias, work, out=work if p.inplace else None, **kw),
            reps=10))
        out = torch.empty_like(want)

        def run(entry, v=None):
            r = work if p.inplace else res
            ptrs, dims = fc.product_pointers(a, w, bias, r, r if p.inplace else out,
                                             geglu_out=p.geglu, split=p.split)
            st = fc.stream_of(a)
            kb.check(entry(ptrs, dims, st) if v is None else entry(v, ptrs, dims, st), "var")

        wt = w.t()
        row("torch.matmul", cs.time_ms(lambda: torch.matmul(a, wt), reps=10))
        for v, name, whole in VARIANTS:
            err = None
            if whole:
                if p.inplace:
                    work.copy_(res)
                run(vlib.mc_var, v)
                got = work if p.inplace else out
                err = (got.float() - want.float()).abs().max().item()
            row(name, cs.time_ms(lambda: run(vlib.mc_var, v), reps=10), err)
        del a, w, bias, res, want, work, out
        torch.cuda.empty_cache()
    conv_variants(vlib, dev, gen)
    print(cs.nvidia_smi())
    return 0


def conv_variants(vlib, dev, gen) -> None:
    """Kernel 8's convolution on 128- and 256-row tiles: conv1's flavour
    without the temb row (+ bias, f32 out) at every shape of CONV_SHAPES,
    and conv2's with the 1x1 shortcut's f32 residual (+ bias + residual,
    bf16 out) at those of RES_SHAPES."""
    import chip_smoke as cs
    from torch.nn import functional as F

    from motionclone_tpu_torch.ops import build as kb
    from motionclone_tpu_torch.ops import fused_common as fc
    from motionclone_tpu_torch.ops import fused_resnet as fr

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(shape, False) for shape in CONV_SHAPES] + [(shape, True) for shape in RES_SHAPES]
    for (hw, cin, cout, bf), with_res in cases:
        act = torch.randn(bf, hw, hw, cin, generator=gen, device=dev).to(bf16)
        wt = (torch.randn(cout, 3, 3, cin, generator=gen, device=dev) * (9 * cin) ** -0.5).to(bf16)
        wk = wt.reshape(cout, 9 * cin)
        bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
        res = (torch.randn(bf, hw, hw, cout, generator=gen, device=dev) if with_res else None)
        out_dtype = bf16 if with_res else f32
        want = fr.conv3x3(act, wk, bias, res=res, out_dtype=out_dtype)
        out = torch.empty_like(want)
        m = bf * hw * hw
        flops = 2 * m * cout * 9 * cin
        print(f"conv (B·F, H, W, Cin, Cout)=({bf}, {hw}, {hw}, {cin}, {cout}) "
              f"(M, N, K)=({m}, {cout}, {9 * cin}) "
              f"{'+ f32 residual, bf16 out' if with_res else 'f32 out'}", flush=True)

        def row(name, ms, err=None):
            e = "" if err is None else f" max_diff_vs_shipped={err:.3e}"
            print(f"  {name:28s} {ms:.4f} ms {flops / ms / 1e9:7.1f} TFLOP/s{e}", flush=True)

        row("shipped conv3x3", cs.time_ms(
            lambda: fr.conv3x3(act, wk, bias, res=res, out_dtype=out_dtype), reps=10))
        x_cl, w_cl, b16 = act.permute(0, 3, 1, 2), wt.permute(0, 3, 1, 2), bias.to(bf16)
        row("cuDNN conv2d", cs.time_ms(lambda: F.conv2d(x_cl, w_cl, b16, padding=1), reps=10))
        ptrs = kb.pointers(act, wk, bias, None, res, out)
        dims = kb.ints(bf, 16, hw, hw, cin, cout, int(with_res), int(not with_res))
        st = fc.stream_of(act)

        def run(v):
            kb.check(vlib.mc_var_conv(v, ptrs, dims, st), "var_conv")

        for v, name, whole in CONV_VARIANTS:
            err = None
            if whole:
                run(v)
                err = (out.float() - want.float()).abs().max().item()
            row(name, cs.time_ms(lambda: run(v), reps=10), err)
        del act, wt, wk, bias, res, want, out, x_cl, w_cl, b16, ptrs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
