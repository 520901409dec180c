"""Time the design variants of the temporal attention kernels on one H100.

    python3 scripts/torch_temporal_variants.py

Builds ``scripts/torch_temporal_variants.cu`` (the variants, on the port's
own kernel template in ``csrc/temporal_attention.cuh``) with ``nvcc`` for
``sm_90a`` into ``build/``, then at the 64x64 level (4096 pixels, 8 heads
of 40) times each variant of the forward (kernel 3 at B = 1 and 2, 3r at 8
query frames) and of the backward (4, 4r) beside the shipped kernel
through its wrapper, with the largest difference of each whole variant
from the shipped kernel's outputs (0 expected: the variants change where
the bytes go, not the arithmetic), and the share of the bound (bytes over
3.35 TB/s) each reaches; "loads alone" prints the rate of the bytes it
reads.  The head of the ``.cu`` file says what each variant changes.
Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (index, name, whole kernel?) in the order of the .cu file's variant()
VARIANTS = [
    (0, "shipped (1 pixel, 2 stages, 336 B pitch)", True),
    (1, "320 B pitch (4-way conflicts)", True),
    (2, "3 stages", True),
    (3, "2 pixels a tile", True),
    (4, "loads alone", False),
    (5, "loads and stores, no products", False),
    (6, "loads alone, 3 stages", False),
    (7, "block ring, 7 consumers (bwd 5)", True),
    (8, "block ring, 11 consumers (bwd 8)", True),
]
# (B, query frames, backward?) at S = 4096, heads 8 x 40
CASES = [(1, 16, False), (2, 16, False), (1, 8, False), (1, 16, True), (1, 8, True)]
S, HEADS, D = 4096, 8, 40


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_temporal_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from motionclone_tpu_torch.ops import build as kb
    from motionclone_tpu_torch.ops import temporal_attention as ta

    print(cs.nvidia_smi(), flush=True)
    kb.load_library()
    so = kb.BUILD_DIR / "libtorch_temporal_variants.so"
    out = subprocess.run(
        [kb._nvcc(), *kb.NVCC_FLAGS, "-shared", "-o", str(so),
         str(ROOT / "scripts" / "torch_temporal_variants.cu")],
        capture_output=True, text=True)
    print("\n".join(l for l in (out.stdout + out.stderr).splitlines()
                    if "registers" in l or "spill" in l and " 0 bytes spill" not in l))
    if out.returncode:
        print(out.stdout[-4000:], out.stderr[-4000:])
        return 1
    vlib = ctypes.CDLL(str(so))
    vlib.mc_tvar.argtypes = (ctypes.c_int,) * 3 + (ctypes.c_void_p,) + (ctypes.c_int,) * 3 + (
        ctypes.c_float, ctypes.c_void_p)
    vlib.mc_tvar.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    hd, scale = HEADS * D, D ** -0.5

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    for b, fq, bwd in CASES:
        q, dout = randn(b, fq, S, hd), randn(b, fq, S, hd)
        k, v = randn(b, 16, S, hd), randn(b, 16, S, hd)
        rect = fq != 16
        fwd_fn = ta.temporal_fwd_rect if rect else ta.temporal_fwd
        bwd_fn = ta.temporal_bwd_rect if rect else ta.temporal_bwd
        want_o, lse = fwd_fn(q, k, v, HEADS, scale)
        if bwd:
            want = bwd_fn(q, k, v, lse, dout, HEADS, scale)
            outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
            read = (2 * fq + 32) * b * S * hd * 2 + lse.numel() * 4
            written = (fq + 32) * b * S * hd * 2
            shipped = lambda: bwd_fn(q, k, v, lse, dout, HEADS, scale)
        else:
            want = (want_o, lse)
            outs = [torch.empty_like(q), torch.empty_like(lse)]
            read = (fq + 32) * b * S * hd * 2
            written = fq * b * S * hd * 2 + lse.numel() * 4
            shipped = lambda: fwd_fn(q, k, v, HEADS, scale)
        bound_ms = (read + written) / cs.PEAK_BYTES * 1e3
        o_lse = outs[1] if not bwd else lse
        ptrs = kb.pointers(q, k, v, dout if bwd else None, outs[0],
                           outs[1] if bwd else None, outs[2] if bwd else None, o_lse)
        st = torch.cuda.current_stream().cuda_stream
        print(f"case {'bwd' if bwd else 'fwd'} (B, FQ, S, C)=({b}, {fq}, {S}, {hd}) "
              f"bound_ms={bound_ms:.4f} (bytes)", flush=True)

        def row(name, ms, err=None, rate=None):
            e = "" if err is None else f" max_diff_vs_shipped={err:.3e}"
            r = "" if rate is None else f" read_TB/s={rate:.3f}"
            print(f"  {name:42s} {ms:.4f} ms {bound_ms / ms * 100:5.1f}% of bound{e}{r}",
                  flush=True)

        row("shipped, through its wrapper", cs.time_ms(shipped, reps=50, warmup=5))
        for vi, name, whole in VARIANTS:
            def run():
                kb.check(vlib.mc_tvar(vi, int(bwd), fq, ptrs, b, S, HEADS, scale, st), name)

            err = None
            if whole:
                run()
                got = outs if bwd else (outs[0], outs[1])
                err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            ms = cs.time_ms(run, reps=50, warmup=5)
            row(name, ms, err, read / ms / 1e9 if vi in (4, 6) else None)
        del q, k, v, dout, outs, want, lse
        torch.cuda.empty_cache()
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
