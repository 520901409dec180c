"""Quick check and per-launch profile of the port's fused kernels on one GPU.

    python3 scripts/torch_fused_kernels.py            # check + time + profile
    python3 scripts/torch_fused_kernels.py --no-profile

Builds the kernel library, runs kernels 5-8 (fused spatial transformer,
transformer block, motion module, resnet) once each at a few main-path
shapes with random bf16 weights and inputs, holds each against its plain
PyTorch version (tolerance 2e-3 + 2e-2 * max|ref|, as chip_smoke.py) and
prints its time; then, unless ``--no-profile``, the device time of every
launch inside one call of each, under torch.profiler, beside cuBLAS on
three product shapes of the same modules.  A shorter loop than
chip_smoke.py's phase 2, for iterating on the kernels.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from motionclone_tpu_torch.ops import build as kb  # noqa: E402
from motionclone_tpu_torch.ops import fused_block as fb  # noqa: E402
from motionclone_tpu_torch.ops import fused_resnet as fr  # noqa: E402
from motionclone_tpu_torch.ops import fused_temporal as ft  # noqa: E402

HEADS, GROUPS = 8, 32


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-profile", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_kernels: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kb.load_library()
    print(f"build: nvcc {kb.build_info.get('seconds', 0.0):.1f} s")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def mat(o, i):
        return (torch.randn(o, i, generator=gen, device=dev) * i ** -0.5).to(torch.bfloat16)

    def vec(n, one=False):
        return (1.0 if one else 0.0) + 0.1 * torch.randn(n, generator=gen, device=dev)

    def act(*s):
        return torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)

    def time_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def check(name, fn, ref):
        got = fn()
        torch.cuda.synchronize()
        got = got[: ref.shape[0]]
        err = (got.float() - ref.float()).abs().max().item()
        tol = 2e-3 + 2e-2 * ref.float().abs().max().item()
        print(f"{name}: max_abs_err {err:.3e} tol {tol:.3e} "
              f"{'OK' if err <= tol else 'FAIL'} ms {time_ms(fn):.4f}", flush=True)
        if err > tol:
            raise AssertionError(name)

    def block_weights(c):
        return fb.BlockWeights(
            vec(c, 1), vec(c), mat(3 * c, c), mat(c, c), vec(c), vec(c, 1), vec(c),
            mat(c, c), mat(2 * c, 768), mat(c, c), vec(c), vec(c, 1), vec(c),
            mat(8 * c, c), vec(8 * c), mat(c, 4 * c), vec(c))

    def temporal_weights(c):
        att = tuple(ft.AttnWeights(vec(c, 1), vec(c), mat(3 * c, c), mat(c, c), vec(c))
                    for _ in range(2))
        return ft.TemporalModuleWeights(
            vec(c, 1), vec(c), act(24, c), mat(c, c), vec(c), att, vec(c, 1), vec(c),
            mat(8 * c, c), vec(8 * c), mat(c, 4 * c), vec(c), mat(c, c), vec(c))

    def resnet_weights(cin, cout):
        sc = cin != cout
        return fr.ResnetWeights(
            vec(cin, 1), vec(cin), mat(cout, 9 * cin), vec(cout), vec(cout, 1), vec(cout),
            mat(cout, 9 * cout), vec(cout), mat(cout, cin) if sc else None,
            vec(cout) if sc else None)

    cases = {}
    with torch.no_grad():
        for bf, hw, cin, cout in ((16, 64, 320, 320), (16, 32, 320, 640), (16, 64, 640, 320)):
            w, x, t = resnet_weights(cin, cout), act(1, bf, hw, hw, cin), act(1, cout)
            fn = lambda w=w, x=x, t=t: fr.fused_resnet_kernel(x, t, w, groups=GROUPS, eps=1e-5)
            check(f"resnet {bf}x{hw}^2 {cin}->{cout}", fn,
                  fr.fused_resnet_block_plain(x, t, w, groups=GROUPS, eps=1e-5))
            cases.setdefault("resnet", fn)
        for b, s, c in ((1, 4096, 320), (2, 1024, 640)):
            w, x = temporal_weights(c), act(b, 16, s, c)
            fn = lambda w=w, x=x: ft.fused_temporal_kernel(x, w, heads=HEADS, groups=GROUPS)
            check(f"temporal {b}x16x{s}x{c}", fn,
                  ft.fused_temporal_module_plain(x, w, heads=HEADS, groups=GROUPS))
            cases.setdefault("temporal", fn)
        for s, c in ((4096, 320), (1024, 640)):
            blk, x, ctx = block_weights(c), act(16, s, c), act(1, 77, 768)
            wt = fb.TransformerWeights(vec(c, 1), vec(c), mat(c, c), vec(c), blk, mat(c, c), vec(c))
            fn = lambda wt=wt, x=x, ctx=ctx: fb.fused_spatial_transformer_kernel(
                x, ctx, wt, heads=HEADS, groups=GROUPS, frames=16)
            # 4 frames of the plain version bound its (4, 8, S, S) f32 logits
            check(f"transformer 16x{s}x{c}", fn, fb.fused_spatial_transformer_plain(
                x[:4], ctx, wt, heads=HEADS, groups=GROUPS, frames=4))
            fn_b = lambda blk=blk, x=x, ctx=ctx: fb.fused_transformer_block_kernel(
                x, ctx, blk, heads=HEADS, frames=16)
            check(f"block 16x{s}x{c}", fn_b, fb.fused_transformer_block_plain(
                x[:4], ctx, blk, heads=HEADS, frames=4))
            cases.setdefault("transformer", fn)
            torch.cuda.empty_cache()
        if args.no_profile:
            return 0
        a, a4 = act(65536, 320), act(65536, 1280)
        w1, w4, w8 = mat(320, 320), mat(320, 1280), mat(2560, 320)
        cases["cuBLAS (65536, 320) x (320, 320)"] = lambda: a @ w1.t()
        cases["cuBLAS (65536, 1280) x (1280, 320)"] = lambda: a4 @ w4.t()
        cases["cuBLAS (65536, 320) x (320, 2560)"] = lambda: a @ w8.t()
        for name, fn in cases.items():
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            total, count = defaultdict(float), defaultdict(int)
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    total[e.name] += e.device_time_total / 1e3
                    count[e.name] += 1
            print(f"== {name}: {sum(total.values()):.4f} ms of device time")
            for k, v in sorted(total.items(), key=lambda kv: -kv[1]):
                print(f"   {v:8.4f} ms x{count[k]}  {k[:140]}")
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
