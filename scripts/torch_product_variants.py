"""Time the design variants of the product of kernels 5-7 on one H100.

    python3 scripts/torch_product_variants.py

Builds ``scripts/torch_product_variants.cu`` (the variants, on the port's
own device code in ``csrc/fused_product.cuh``) with ``nvcc`` for ``sm_90a``
into ``build/``, then at main-path product shapes times each variant beside
the shipped product (``fused_common.fused_product``), the fused resnet's
mma.sync product and ``torch.matmul``, with the largest difference of each
whole-product variant from the shipped product's output.  The head of the
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
    vlib.mc_var.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
    vlib.mc_var.restype = ctypes.c_int
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

        row("mma.sync product", cs.time_ms(lambda: run(lib.mc_mma_product), reps=10))
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
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
