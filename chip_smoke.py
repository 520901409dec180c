"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phase 0  device: exits non-zero without CUDA; prints the card's name and
         power limit (nvidia-smi).
Phase 1  build: compiles motionclone_tpu_torch/csrc/*.cu with nvcc for
         sm_90a (one process per source) and prints the seconds it took.
Phase 2  kernels: each of the four kernels (flash fwd/bwd, temporal fwd/bwd)
         at every shape the main path gives it, held against its plain
         PyTorch version on the same bf16 inputs over the whole batch, with
         times beside the bound (989 TFLOP/s bf16, 3.35 TB/s) and beside
         PyTorch's own attention as a yardstick that the port never calls:
         F.scaled_dot_product_attention for the forwards, the aten flash
         attention backward op (fed its own forward's out and LSE) for the
         backwards.  Temporal attention is handed to them as a strided
         (B, S*heads, F, D) view of its (B, F, S, heads*D) tensors.
Phase 3  main path: guided text-to-video sampling at SD1.5 + AnimateDiff v3
         width, 512x512x16 frames, random weights from a seed: CLIP on random
         token ids for the CFG pair, VAE encode of a random video,
         extraction, 2 guided + 2 vanilla DDIM steps (the t2v_camera schedule
         cut from 100 steps), VAE decode.  Every output must be finite and of
         its shape, and each kernel must have launched in this phase.
Phase 4  reference: the port on the card (bf16, kernels) against the port
         on the CPU (f32, plain versions) at reduced depth and size.
Phase 5  only with ``--profile DIR``: one guided and one vanilla step of the
         main path's pipeline under torch.profiler: wall time, the device's
         busy and idle share, device time by category and the top kernels,
         and a chrome trace per step in DIR.

The line before the last is the kernels JSON; the last line is the result
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3

# (S, head dim) of the spatial and temporal attentions at 512x512 latents
# (64x64, 32x32, 16x16, 8x8 with 320/640/1280/1280 channels over 8 heads)
ATTN_SHAPES = ((4096, 40), (1024, 80), (256, 160), (64, 160))
HEADS = 8
# tolerance of a bf16 kernel against its f32-math plain version on the same
# bf16 inputs: bf16 rounds P before the P@V product and every output at
# 2**-8 relative, so errors scale with the output's magnitude
RTOL = 2e-2
ATOL = 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def max_err(got, ref) -> tuple:
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    mag = max(r.float().abs().max().item() for r in ref)
    return err, ATOL + RTOL * mag


def batch_slices(b: int, nb: int):
    """Slices of at most ``nb`` that cover the whole batch: they bound the
    plain version's (nb, heads, S, S) f32 logits at S = 4096."""
    return [slice(i, min(i + nb, b)) for i in range(0, b, nb)]


def flash_view(x, b, s, d):
    """(B, S, heads*D) -> the (B, heads, S, D) view PyTorch's attention takes."""
    return x.view(b, s, HEADS, d).transpose(1, 2)


def temporal_view(x, b, f, s, d):
    """(B, F, S, heads*D) -> a (B, S*heads, F, D) view: one attention over
    the F frames per (pixel, head), as the temporal kernels compute."""
    return x.view(b, f, s * HEADS, d).transpose(1, 2)


def library_bwd(q4, k4, v4, do4, scale):
    """(ms, (dq, dk, dv)) of PyTorch's flash attention backward on 4-D
    views, fed the out and LSE of its own forward."""
    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, offset = aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, False, False, scale=scale)[:8]

    def run():
        return aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, out, lse, cq, ck, mq, mk, 0.0, False, seed, offset,
            scale=scale)

    return time_ms(run), run()


# ---------------------------------------------------------------------------
# phase 2: the kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(dev) -> dict:
    from torch.nn import functional as F

    from motionclone_tpu_torch.ops import flash_attention as fa
    from motionclone_tpu_torch.ops import temporal_attention as ta

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    rows = {}

    def record(name, shape, err, tol, ms, plain_ms, b_ms, b_by, lib_ms, lib_dev):
        ok = err <= tol
        log(
            f"kernel {name:13s} shape={shape} max_abs_err={err:.3e} tol={tol:.3e} "
            f"{'OK' if ok else 'FAIL'} kernel_ms={ms:.4f} plain_ms={fmt(plain_ms)} "
            f"bound_ms={b_ms:.4f} ({b_by}) library_ms={fmt(lib_ms)} "
            f"library_vs_kernel={lib_dev:.3e}"
        )
        if not ok:
            raise AssertionError(f"{name} at {shape}: error {err} > tolerance {tol}")
        # the JSON line carries the 64x64 (S=4096) shape: the main path's largest
        if shape[-2 if name.startswith("temporal") else 1] == 4096 and name not in rows:
            rows[name] = dict(shape=list(shape), max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms)

    for s, d in ATTN_SHAPES:
        hd = HEADS * d
        scale = d ** -0.5
        # flash forward, B*F = 16 (one CFG half) and 32 (the vanilla pair)
        for b in (16, 32):
            q, k, v = randn(b, s, hd), randn(b, s, hd), randn(b, s, hd)
            out, lse = fa.flash_fwd(q, k, v, HEADS, scale)
            torch.cuda.synchronize()
            got, ref, lse_err = [], [], 0.0
            for sl in batch_slices(b, 4 if s == 4096 else b):
                ref_out, ref_lse = fa.flash_attention_plain(q[sl], k[sl], v[sl], HEADS, scale)
                got.append(out[sl])
                ref.append(ref_out)
                lse_err = max(lse_err, (lse[sl] - ref_lse).abs().max().item())
            err, tol = max_err(got, ref)
            if lse_err > 1e-2:
                raise AssertionError(f"flash_fwd lse error {lse_err} at {(b, s, hd)}")
            del got, ref, ref_out, ref_lse
            ms = time_ms(lambda: fa.flash_fwd(q, k, v, HEADS, scale))
            plain_ms = None  # the plain (B, heads, S, S) f32 logits would pass 40 GB
            if b * s * s <= 16 * 4096 * 4096:
                plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, HEADS, scale),
                                   reps=3, warmup=1)
            q4, k4, v4 = (flash_view(x, b, s, d) for x in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            lib_ms = time_ms(lib)
            lib_dev = (lib().transpose(1, 2).reshape(b, s, hd).float() - out.float()).abs().max().item()
            b_ms, b_by = bound(4 * b * s * s * hd, (4 * b * s * hd) * 2 + b * HEADS * s * 4)
            record("flash_fwd", (b, s, HEADS, d), err, tol, ms, plain_ms, b_ms, b_by,
                   lib_ms, lib_dev)
            torch.cuda.empty_cache()

        # flash backward, B*F = 16 (the cond pass)
        b = 16
        q, k, v, dout = (randn(b, s, hd) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, HEADS, scale)
        grads = fa.flash_bwd(q, k, v, out, lse, dout, HEADS, scale)
        torch.cuda.synchronize()
        got, ref = [], []
        for sl in batch_slices(b, 2 if s == 4096 else b):
            got.extend(g[sl] for g in grads)
            ref.extend(fa.flash_attention_bwd_plain(q[sl], k[sl], v[sl], dout[sl], HEADS, scale))
        err, tol = max_err(got, ref)
        del got, ref
        ms = time_ms(lambda: fa.flash_bwd(q, k, v, out, lse, dout, HEADS, scale))
        plain_ms = time_ms(
            lambda: fa.flash_attention_bwd_plain(q, k, v, dout, HEADS, scale),
            reps=2, warmup=1,
        )
        lib_ms, lib_grads = library_bwd(*(flash_view(x, b, s, d) for x in (q, k, v, dout)),
                                        scale)
        lib_dev = max((lg.transpose(1, 2).reshape(b, s, hd).float() - g.float()).abs().max().item()
                      for lg, g in zip(lib_grads, grads))
        del lib_grads
        b_ms, b_by = bound(10 * b * s * s * hd,
                           (8 * b * s * hd) * 2 + b * HEADS * s * 4)
        record("flash_bwd", (b, s, HEADS, d), err, tol, ms, plain_ms, b_ms, b_by,
               lib_ms, lib_dev)
        torch.cuda.empty_cache()

        # temporal forward, batch 1 (one CFG half) and 2 (the vanilla pair)
        f = 16
        for b in (1, 2):
            q, k, v = (randn(b, f, s, hd) for _ in range(3))
            out, lse = ta.temporal_fwd(q, k, v, HEADS, scale)
            torch.cuda.synchronize()
            ref_out, ref_lse = ta.temporal_attention_plain(q, k, v, HEADS, scale)
            err, tol = max_err((out,), (ref_out,))
            lse_err = (lse - ref_lse).abs().max().item()
            if lse_err > 1e-2:
                raise AssertionError(f"temporal_fwd lse error {lse_err} at {(b, f, s, hd)}")
            ms = time_ms(lambda: ta.temporal_fwd(q, k, v, HEADS, scale), reps=20)
            plain_ms = time_ms(lambda: ta.temporal_attention_plain(q, k, v, HEADS, scale))
            q4, k4, v4 = (temporal_view(x, b, f, s, d) for x in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            lib_ms = time_ms(lib, reps=20)
            lib_dev = (lib().transpose(1, 2).reshape(b, f, s, hd).float()
                       - out.float()).abs().max().item()
            b_ms, b_by = bound(4 * b * s * HEADS * f * f * d,
                               (4 * b * f * s * hd) * 2 + b * s * HEADS * f * 4)
            record("temporal_fwd", (b, f, s, hd), err, tol, ms, plain_ms, b_ms, b_by,
                   lib_ms, lib_dev)

        # temporal backward, batch 1 (the cond pass)
        b = 1
        q, k, v, dout = (randn(b, f, s, hd) for _ in range(4))
        _, lse = ta.temporal_fwd(q, k, v, HEADS, scale)
        grads = ta.temporal_bwd(q, k, v, lse, dout, HEADS, scale)
        torch.cuda.synchronize()
        ref = ta.temporal_attention_bwd_plain(q, k, v, dout, HEADS, scale)
        err, tol = max_err(grads, ref)
        ms = time_ms(lambda: ta.temporal_bwd(q, k, v, lse, dout, HEADS, scale), reps=20)
        plain_ms = time_ms(lambda: ta.temporal_attention_bwd_plain(q, k, v, dout, HEADS, scale))
        lib_ms, lib_grads = library_bwd(
            *(temporal_view(x, b, f, s, d) for x in (q, k, v, dout)), scale)
        lib_dev = max((lg.transpose(1, 2).reshape(b, f, s, hd).float() - g.float()).abs().max().item()
                      for lg, g in zip(lib_grads, grads))
        b_ms, b_by = bound(10 * b * s * HEADS * f * f * d,
                           (7 * b * f * s * hd) * 2 + b * s * HEADS * f * 4)
        record("temporal_bwd", (b, f, s, hd), err, tol, ms, plain_ms, b_ms, b_by,
               lib_ms, lib_dev)
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at SD1.5 + AnimateDiff v3 width
# ---------------------------------------------------------------------------


def init_scaled_(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights that keep activations O(1) through the depth:
    fan-in-scaled normal kernels, norm scales near 1, small biases.  No
    projection is zero (a zero motion-module proj_out would feed the
    temporal backward nothing but zeros)."""
    with torch.no_grad():
        for m in module.modules():
            for name, p in m.named_parameters(recurse=False):
                if isinstance(m, torch.nn.Embedding):
                    p.normal_(0.0, 0.5, generator=gen)
                elif p.dim() >= 2:
                    p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
                elif name == "weight":
                    p.normal_(1.0, 0.1, generator=gen)
                else:
                    p.normal_(0.0, 0.1, generator=gen)


def build_model(cls, cfg, dev, gen, dtype):
    with torch.device("meta"):
        model = cls(cfg)
    model.to_empty(device=dev)
    init_scaled_(model, gen)
    return model.to(dtype)


def t2v_config(**overrides):
    from motionclone_tpu_torch.config import InferenceConfig

    # configs/t2v_camera.yaml with the schedule cut from 100 steps (50 guided,
    # warm-up 10, cool-down 10) to 4 steps (2 guided, warm-up 1, cool-down 1)
    kw = dict(cfg_scale=7.5, inference_steps=4, guidance_fraction=0.3,
              guidance_steps=2, warm_up_steps=1, cool_up_steps=1,
              motion_guidance_weight=2000.0,
              motion_guidance_blocks=("up_blocks.1",), add_noise_step=400,
              width=512, height=512, video_length=16)
    kw.update(overrides)
    return InferenceConfig(**kw)


def main_path(dev, wrappers, profile_dir=None) -> dict:
    """Text embeddings, VAE encode, extraction, 2 guided + 2 vanilla steps
    and VAE decode at 512x512x16 frames, through the port's entry points;
    then, with ``profile_dir``, phase 5 on the same pipeline."""
    from motionclone_tpu_torch.config import NoiseScheduleConfig, UNet3DConfig
    from motionclone_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    gen = torch.Generator(device=dev).manual_seed(1234)
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    unet_cfg = UNet3DConfig()  # SD1.5 + AnimateDiff v3: 320/640/1280/1280, 8 heads
    infer = t2v_config()
    pipe = MotionClonePipeline(
        unet_cfg, NoiseScheduleConfig(), infer,
        build_model(UNet3DConditionModel, unet_cfg, dev, gen, dtype),
        vae=build_model(AutoencoderKL, VAEConfig(), dev, gen, dtype),
        text_encoder=build_model(CLIPTextModel, CLIPTextConfig(), dev, gen, dtype),
        device=dev, dtype=dtype,
    )
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    ids = torch.randint(0, 49408, (2, 77), generator=gen, device=dev)
    video = torch.rand(16, 512, 512, 3, generator=gen, device=dev) * 2 - 1
    torch.cuda.synchronize()
    log(f"main path: UNet {n_params / 1e9:.3f} B params, schedule cut to "
        f"{infer.inference_steps} steps ({infer.guidance_steps} guided), "
        f"set-up {time.perf_counter() - t0:.1f} s")

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    phases = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phases[name] = time.perf_counter() - t
        return out

    emb = timed("text", lambda: pipe.encode_text(ids))
    uncond, cond = emb[:1], emb[1:]
    latents = timed("vae_encode", lambda: pipe.encode_video(video, seed=1))
    rep = timed("extract", lambda: pipe.extract_motion_representation(latents, uncond, seed=2))
    counts_after_extract = {n: w.launches for n, w in wrappers.items()}
    steps = []
    last = [0.0]

    def on_step(i, guided):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append((guided, (now - last[0]) * 1e3))
        last[0] = now

    def run_sample():
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        return pipe.sample_latents(uncond, cond, rep, seed=3, on_step=on_step)

    out = timed("sample", run_sample)
    frames = timed("vae_decode", lambda: pipe.decode_latents(out))
    launches = {n: w.launches for n, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    checks = {
        "text": (emb, (2, 77, 768)), "latents": (latents, (1, 16, 64, 64, 4)),
        "sample": (out, (1, 16, 64, 64, 4)), "frames": (frames, (16, 512, 512, 3)),
    }
    for name, (x, shape) in checks.items():
        if tuple(x.shape) != shape or not torch.isfinite(x.float()).all():
            raise AssertionError(f"main path {name}: shape {tuple(x.shape)} "
                                 f"(want {shape}) or non-finite values")
    if len(rep) != 6:  # up_blocks.1: 3 motion modules x 2 attention blocks
        raise AssertionError(f"motion representation has {len(rep)} modules")
    for name, (vals, idx) in rep.items():
        if vals.shape != (1, 256, 8, 16, 1) or not torch.isfinite(vals).all() \
                or int(idx.max()) >= 16:
            raise AssertionError(f"motion representation {name} malformed")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")

    for name, sec in phases.items():
        log(f"phase {name}: {sec:.3f} s")
    for kind, flag in (("guided", True), ("vanilla", False)):
        ms = [m for g, m in steps if g == flag]
        log(f"{kind} steps: {len(ms)}, ms per step: " + ", ".join(f"{m:.1f}" for m in ms))
    log(f"peak device memory: {peak_gb:.2f} GB")
    log(f"launches in extraction: {counts_after_extract}")
    log(f"launches on the main path: {launches}")
    if profile_dir is not None:
        t, tp = (int(x) for x in pipe.fns.timesteps[:2])
        lat = out.to(dtype)
        profile_steps(profile_dir, {
            "guided step": lambda: pipe.fns.guided_step(lat, t, tp, 1.0, uncond, cond, rep),
            "vanilla step": lambda: pipe.fns.vanilla_step(lat, t, tp, uncond, cond),
        })
    return launches


# ---------------------------------------------------------------------------
# phase 5 (--profile): where a guided and a vanilla step spend the card's time
# ---------------------------------------------------------------------------


def category(name: str) -> str:
    n = name.lower()
    if "flash_" in n and "kernel" in n:
        return "flash attention (port kernels)"
    if "temporal_" in n and "kernel" in n:
        return "temporal attention (port kernels)"
    if "conv" in n or "implicit" in n or "wgrad" in n or "dgrad" in n or "xmma" in n:
        return "convolution"
    if "gemm" in n or "cutlass" in n or "sm90_" in n or "nvjet" in n:
        return "matrix product"
    if "reduce" in n or "norm" in n:
        return "reduction / norm"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    if "copy" in n or "memcpy" in n or "memset" in n or "cat" in n:
        return "copy / layout"
    return "other"


def profile_steps(out_dir: str, steps: dict) -> None:
    """Each step once under torch.profiler (the main path has warmed them
    up): wall time, device busy and idle share, device time by category and
    the top kernels; a chrome trace per step in ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, fn in steps.items():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        by_kernel = defaultdict(float)
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                by_kernel[evt.name] += evt.device_time_total / 1e3  # ms
        busy = sum(by_kernel.values())
        log(f"profile {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
            f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
        cats = defaultdict(float)
        for name, ms in by_kernel.items():
            cats[category(name)] += ms
        for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
            log(f"  {cat:36s} {ms:9.2f} ms {100 * ms / busy:5.1f}%")
        log("  top kernels:")
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
            log(f"    {ms:8.2f} ms  {name[:110]}")
        prof.export_chrome_trace(os.path.join(out_dir, label.replace(" ", "_") + ".json"))


def reference_check(dev) -> None:
    """The port on the card (bf16, kernels) against the port on the CPU
    (f32, plain versions) at a reduced depth that keeps the card's kernel
    shapes: SD1.5 channels 320/640, 8 heads (head dims 40/80), 16 frames,
    16x16 latents; one guided and one vanilla step from the same inputs."""
    from motionclone_tpu_torch.config import NoiseScheduleConfig, UNet3DConfig
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.pipeline.motionclone import make_sampling_fns

    cfg = UNet3DConfig(
        down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
        up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
        block_out_channels=(320, 640), layers_per_block=1,
    )
    infer = t2v_config(width=128, height=128)
    gen = torch.Generator().manual_seed(99)
    ref = UNet3DConditionModel(cfg)
    init_scaled_(ref, gen)
    card = UNet3DConditionModel(cfg)
    card.load_state_dict(ref.state_dict())
    card = card.to(device=dev, dtype=torch.bfloat16)
    shape = (1, 16, 16, 16, 4)
    lat, noise = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
    uncond, cond = torch.randn(1, 77, 768, generator=gen), torch.randn(1, 77, 768, generator=gen)
    results = {}
    for name, unet, d in (("cpu", ref, "cpu"), ("cuda", card, dev)):
        # inputs and the DDIM step math stay f32 on both sides; only the
        # card's UNet computes in bf16
        fns = make_sampling_fns(unet, NoiseScheduleConfig(), infer)
        mv = lambda x: x.to(device=d)
        rep = fns.extract(mv(lat), mv(noise), mv(uncond))
        t, tp = (int(x) for x in fns.timesteps[:2])
        guided, loss = fns.guided_step(mv(lat), t, tp, 1.0, mv(uncond), mv(cond), rep)
        t, tp = int(fns.timesteps[2]), int(fns.timesteps[3])
        vanilla = fns.vanilla_step(mv(lat), t, tp, mv(uncond), mv(cond))
        with torch.no_grad():
            pred, _ = unet(mv(lat), t, mv(cond))
        results[name] = {
            "rep_values": torch.cat([v.flatten() for v, _ in rep.values()]),
            "noise_pred": pred,
            "guided_update": guided - mv(lat), "vanilla_update": vanilla - mv(lat),
            "loss": loss.reshape(1),
        }
    # bf16 weights and activations through the whole depth against f32: a
    # few 1e-3 of relative error per layer, compounded.  The steps' updates
    # carry CFG, cond + 7.5 * (cond - uncond), which multiplies the error of
    # the small cond - uncond difference by 8.5, and the guidance gradient.
    tols = {"rep_values": 3e-2, "noise_pred": 3e-2, "guided_update": 1e-1,
            "vanilla_update": 1e-1, "loss": 1e-1}
    for key, tol in tols.items():
        a = results["cpu"][key].float()
        b = results["cuda"][key].float().cpu()
        rel = ((a - b).norm() / a.norm()).item()
        ok = rel <= tol
        log(f"reference {key}: relative L2 error {rel:.3e} (tol {tol:.0e}) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"reference check {key}: {rel}")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


KERNELS = {
    "flash_fwd": ("motionclone_tpu_torch/csrc/flash_attention.cu",
                  "motionclone_tpu/ops/flash_attention.py:204"),
    "flash_bwd": ("motionclone_tpu_torch/csrc/flash_attention.cu",
                  "motionclone_tpu/ops/flash_attention.py:443"),
    "temporal_fwd": ("motionclone_tpu_torch/csrc/temporal_attention.cu",
                     "motionclone_tpu/ops/temporal_attention.py:147"),
    "temporal_bwd": ("motionclone_tpu_torch/csrc/temporal_attention.cu",
                     "motionclone_tpu/ops/temporal_attention.py:172"),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile one guided and one vanilla step, "
                             "writing chrome traces to DIR (phase 5)")
    args = parser.parse_args()
    # phase 0: device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from motionclone_tpu_torch.ops import build as kbuild
    from motionclone_tpu_torch.ops import flash_attention as fa
    from motionclone_tpu_torch.ops import temporal_attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = nvidia_smi()
    log(f"card: {card}")

    # phase 1: build
    t0 = time.perf_counter()
    kbuild.load_library()
    log(f"phase build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kbuild.build_info.get('seconds', 0.0):.1f} s, "
        f"cached={kbuild.build_info.get('cached')})")
    if "log" in kbuild.build_info:  # ptxas -v: registers and spills per kernel
        for line in kbuild.build_info["log"].splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                log("  ptxas " + line.strip())

    # phase 2: kernels against their plain versions
    t0 = time.perf_counter()
    rows = check_kernels(dev)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    wrappers = {"flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
                "temporal_fwd": ta.temporal_fwd, "temporal_bwd": ta.temporal_bwd}
    # phase 3: the main path (the only window the launch counts cover)
    t0 = time.perf_counter()
    launches = main_path(dev, wrappers, args.profile)
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # phase 4: the card against the CPU at a reduced depth
    t0 = time.perf_counter()
    reference_check(dev)
    log(f"phase reference: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            **rows[name]))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
