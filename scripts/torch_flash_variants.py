"""Time the design variants of the flash forward (kernel 1) on one H100.

    python3 scripts/torch_flash_variants.py

Builds ``scripts/torch_flash_variants.cu`` (the variants, on the port's own
device code) with ``nvcc`` for ``sm_90a`` into ``build/``, checks wgmma's
descriptor layout on two single products, then times each variant beside
the shipped kernel and ``F.scaled_dot_product_attention`` at the main
path's 64x64 and 32x32 shapes, with the largest difference from the
shipped kernel's output.  The head of the ``.cu`` file says what each
variant changes.  Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HEADS = 8
# (variant, head dim) in the order of the .cu file's list
VARIANTS = [
    ("x_base128", 40), ("x_noexp128", 40), ("x_noexp_nopv128", 40), ("x_pipe128", 40),
    ("x_pipe64_2", 40), ("x_fast64_2", 40), ("x_fastnoexp64_2", 40),
    ("x_fastnofence64_2", 40), ("x_fast64_3", 40), ("x_qreg64_2", 40),
    ("x_pingpong64_2", 40), ("x_dec64_2", 40), ("x_1wg64_3", 40), ("x_4wg64", 40),
    ("x_4wgdec64", 40), ("x_2wgdec80", 80), ("x_4wgdec80", 80),
]
SHAPES = ((16, 4096, 40), (16, 1024, 80))  # (B*F, S, head dim)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from motionclone_tpu_torch.ops import build as kb
    from motionclone_tpu_torch.ops import flash_attention as fa

    print(cs.nvidia_smi(), flush=True)
    kb.load_library()
    so = kb.BUILD_DIR / "libtorch_flash_variants.so"
    out = subprocess.run(
        [kb._nvcc(), *kb.NVCC_FLAGS, "-shared", "-o", str(so),
         str(ROOT / "scripts" / "torch_flash_variants.cu")],
        capture_output=True, text=True)
    if out.returncode:
        print(out.stdout[-4000:], out.stderr[-4000:])
        return 1
    lib = ctypes.CDLL(str(so))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    # the layout the kernels use: K-major (lead 128, stride DP*16 bytes),
    # MN-major (lead DP*16, stride 128); DP = 16 and 48 here
    for name in ("probe_ss", "probe_rs"):
        getattr(lib, name).argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2
    a, b, v = randn(64, 16), randn(64, 16), randn(16, 40)
    c = torch.zeros(64, 64, device=dev)
    if lib.probe_ss(a.data_ptr(), b.data_ptr(), c.data_ptr(), 128, 256):
        return 1
    print(f"layout K-major x K-major: max error {(c - a.float() @ b.float().T).abs().max().item():.3e}")
    c = torch.zeros(64, 40, device=dev)
    if lib.probe_rs(a.data_ptr(), v.data_ptr(), c.data_ptr(), 768, 128):
        return 1
    print(f"layout registers x MN-major: max error {(c - a.float() @ v.float()).abs().max().item():.3e}")

    for bsz, s, d in SHAPES:
        hd, scale = HEADS * d, d ** -0.5
        q, k, v = (randn(bsz, s, hd) for _ in range(3))
        ref, _ = fa.flash_fwd(q, k, v, HEADS, scale)
        shipped = cs.time_ms(lambda: fa.flash_fwd(q, k, v, HEADS, scale), reps=20)
        q4, k4, v4 = (cs.flash_view(x, bsz, s, d) for x in (q, k, v))
        sdpa = cs.time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, scale=scale), reps=20)
        print(f"({bsz}, {s}, {HEADS}, {d}): shipped {shipped:.4f} ms, SDPA {sdpa:.4f} ms",
              flush=True)
        for name, vd in VARIANTS:
            if vd != d:
                continue
            fn = getattr(lib, name)
            fn.argtypes = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_float,)
            o = torch.empty_like(q)
            lse = torch.empty(bsz, HEADS, s, device=dev)
            run = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             lse.data_ptr(), bsz, HEADS, s, s, scale)
            if run():
                print(f"  {name}: launch refused")
                continue
            torch.cuda.synchronize()
            ms = cs.time_ms(run, reps=20)
            diff = (o.float() - ref.float()).abs().max().item()
            print(f"  {name:18s} {ms:.4f} ms ({ms / sdpa:.3f} x SDPA), "
                  f"max |difference from shipped| {diff:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
