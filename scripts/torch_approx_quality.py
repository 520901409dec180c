"""What the opt-in approx caches change on the PyTorch port: exact against
approx outputs.

Port of scripts/approx_quality.py.  The workload runs at SD1.5 +
AnimateDiff v3 width, 512x512x16 frames, with seeded random bf16 weights
(as chip_smoke.py builds them), random embeddings and a random motion
representation; with real checkpoints the same measurement gives the
production deviation.  Every point, the exact one included (every
override at 1: the exact steps), runs through ONE build with every cache
on (uncond_interval, guidance_interval and step_interval 2), whose
intervals and weights ``sample`` overrides at run time, so the comparison
isolates the caching itself.

Reported per (K_u, K_g, w, K_s, w_s) point, one JSON line on standard
output: the relative L2 deviation of the final latents from the exact
run's, and the PSNR and SSIM of the decoded uint8 frames against the
exact run's (``motionclone_tpu_torch/utils/metrics.py``).

    python3 scripts/torch_approx_quality.py [--workload W] [--time]
        [--device DEV] [KU:KG[:w[:KS[:ws]]] ...]

The default points are 3:1 and 5:2 (KS: the step cache's interval, ws its
extrapolation weight); W is t2v_camera (default, 100 steps of which 50
guided), t2v_object (300/180), i2v (100/40, the RGB SparseCtrl controlnet
on a latent condition) or i2v_sketch (200/120, the sketch controlnet on a
pixel condition).  ``--time`` also times each point and the exact run
(sampling and decode, on fresh latents) as ``sec_per_video``.  DEV is
"cuda" by default; "cpu" runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SIDE, FRAMES = 512, 16
# the schedules of configs/<workload>.yaml, and the chunk each is sampled in
SCHEDULES = {
    "t2v_camera": dict(inference_steps=100, guidance_steps=50, guidance_fraction=0.3,
                       chunk_steps=50),
    "t2v_object": dict(inference_steps=300, guidance_steps=180, guidance_fraction=0.4,
                       chunk_steps=60),
    "i2v": dict(inference_steps=100, guidance_steps=40, guidance_fraction=0.3,
                chunk_steps=60),
    # 40 tiles both phases (120 = 3 x 40, 80 = 2 x 40)
    "i2v_sketch": dict(inference_steps=200, guidance_steps=120, guidance_fraction=0.4,
                       chunk_steps=40),
}
# what every workload shares (configs/*.yaml), beside its schedule
COMMON = dict(warm_up_steps=10, cool_up_steps=10, motion_guidance_weight=2000.0,
              motion_guidance_blocks=("up_blocks.1",), cfg_scale=7.5)
# the build every point runs through: each cache on, overridden at run time
ALL_CACHES = dict(uncond_interval=2, guidance_interval=2, step_interval=2)


def parse_point(arg: str) -> tuple:
    """``KU:KG[:w[:KS[:ws]]]`` -> (K_u, K_g, w, K_s, w_s)."""
    parts = arg.split(":")
    return (int(parts[0]), int(parts[1]) if len(parts) > 1 else 1,
            float(parts[2]) if len(parts) > 2 else 0.0,
            int(parts[3]) if len(parts) > 3 else 1,
            float(parts[4]) if len(parts) > 4 else 0.0)


def point_tag(w: float, ks: int, ws: float) -> str:
    tag = "_extrap" if w else ""
    if ks > 1:
        tag += f"_step{ks}" + ("x" if ws else "")
    return tag


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[dev.index or 0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def init_scaled_(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights that keep activations O(1) through the depth:
    fan-in-scaled normal kernels, norm scales near 1, small biases (no
    projection is zero)."""
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


def model_configs():
    """SD1.5 + AnimateDiff v3's UNet3D and the SD VAE."""
    from motionclone_tpu_torch.config import UNet3DConfig
    from motionclone_tpu_torch.models.vae import VAEConfig

    return UNet3DConfig(), VAEConfig()


def build(workload: str, dev: torch.device, dtype=torch.bfloat16) -> dict:
    """The workload's pipeline with every cache built and its inputs, drawn
    as the JAX script draws them: the initial latents and the embeddings
    from numpy seed 0, then a random motion representation of the guidance
    blocks (values in [0.2, 0.9], random indices); for i2v a condition on
    frame 0 from numpy seed 7 at scale 1."""
    from motionclone_tpu_torch.config import InferenceConfig, NoiseScheduleConfig, load_yaml
    from motionclone_tpu_torch.models.sparse_controlnet import (
        SparseControlNetConfig,
        SparseControlNetModel,
        scatter_condition,
    )
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.models.unet_blocks import probs_keys
    from motionclone_tpu_torch.models.vae import AutoencoderKL
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    sched = dict(SCHEDULES[workload])
    chunk_steps = sched.pop("chunk_steps")
    unet_cfg, vae_cfg = model_configs()
    infer = InferenceConfig(width=SIDE, height=SIDE, video_length=FRAMES,
                            **{**COMMON, **sched})
    gen = torch.Generator(device=dev).manual_seed(1234)
    unet = build_model(UNet3DConditionModel, unet_cfg, dev, gen, dtype)
    vae = build_model(AutoencoderKL, vae_cfg, dev, gen, dtype)
    controlnet = None
    if workload in ("i2v", "i2v_sketch"):
        name = "latent_condition.yaml" if workload == "i2v" else "image_condition.yaml"
        d = load_yaml(os.path.join(ROOT, "configs", "sparsectrl", name))
        cn_cfg = SparseControlNetConfig.from_yaml_dict(d["controlnet_additional_kwargs"],
                                                       unet_cfg)
        controlnet = build_model(SparseControlNetModel, cn_cfg, dev, gen, dtype)
    pipe = MotionClonePipeline(unet_cfg, NoiseScheduleConfig(), infer, unet, vae=vae,
                               controlnet=controlnet, device=dev, dtype=dtype, **ALL_CACHES)

    r = np.random.default_rng(0)
    h = SIDE // 8
    on_dev = lambda a, dt=dtype: torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dt)
    latents = on_dev(r.normal(size=(1, FRAMES, h, h, 4)))
    ctx = unet_cfg.cross_attention_dim
    uncond, cond = on_dev(r.normal(size=(1, 77, ctx))), on_dev(r.normal(size=(1, 77, ctx)))
    # up_blocks.1 works at the side of the second deepest level
    side = h >> (len(unet_cfg.block_out_channels) - 2)
    shape = (1, side * side, unet_cfg.motion_module.num_attention_heads, FRAMES, 1)
    rep = {}
    for m in range(unet_cfg.layers_per_block + 1):
        for key in probs_keys(f"up_blocks.1.motion_modules.{m}", unet_cfg.motion_module):
            rep[key] = (on_dev(r.uniform(0.2, 0.9, size=shape), torch.float32),
                        on_dev(r.integers(0, FRAMES, size=shape), torch.uint8))
    cn_cond = None
    if controlnet is not None:
        rc = np.random.default_rng(7)
        cfg = controlnet.cfg
        if workload == "i2v":  # a 4-channel latent condition
            frames = rc.normal(size=(1, 1, h, h, cfg.conditioning_channels))
        else:  # a 3-channel pixel scribble, downscaled by the conv stack
            frames = rc.uniform(0.0, 1.0, size=(1, 1, SIDE, SIDE, cfg.conditioning_channels))
        c, mask = scatter_condition(on_dev(frames), (0,), FRAMES)
        cn_cond = (c, mask, 1.0)
    return dict(pipe=pipe, chunk_steps=chunk_steps, latents=latents, uncond=uncond,
                cond=cond, rep=rep, cn_cond=cn_cond, infer=infer)


def run(b: dict, point: tuple, latents=None, on_step=None):
    """``sample`` at ``point`` through the build, then the VAE decode ->
    (final latents, f32 numpy; frames, uint8 numpy (F, H, W, 3))."""
    ku, kg, w, ks, ws = point
    pipe = b["pipe"]
    out = pipe.fns.sample(b["latents"] if latents is None else latents, b["uncond"],
                          b["cond"], b["rep"], on_step=on_step, cn_cond=b["cn_cond"],
                          chunk_steps=b["chunk_steps"], uncond_refresh=ku,
                          guidance_refresh=kg, uncond_extrap_w=w, step_refresh=ks,
                          step_extrap_w=ws)
    video = pipe.decode_latents(out).float()
    frames = ((video / 2 + 0.5).clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
    return out.float().cpu().numpy(), frames.cpu().numpy()


def fresh_latents(b: dict) -> torch.Tensor:
    """New initial latents of the run's shape (a timed run starts from them)."""
    lat = b["latents"]
    gen = torch.Generator(device=lat.device).manual_seed(int(time.time()) % 2**31)
    return torch.randn(lat.shape, generator=gen, device=lat.device).to(lat.dtype)


def timed(b: dict, point: tuple) -> float:
    """Seconds of one run on fresh latents, sampling and decode to host."""
    dev = b["latents"].device
    lat = fresh_latents(b)
    sync(dev)
    t0 = time.perf_counter()
    run(b, point, lat)
    sync(dev)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    from motionclone_tpu_torch.pipeline.motionclone import resolve_device
    from motionclone_tpu_torch.utils.metrics import psnr, ssim

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("points", nargs="*", help="KU:KG[:w[:KS[:ws]]] (default 3:1 5:2)")
    p.add_argument("--workload", default="t2v_camera", choices=sorted(SCHEDULES))
    p.add_argument("--time", action="store_true", help="also time each point")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    points = [parse_point(a) for a in args.points] or [(3, 1, 0.0, 1, 0.0),
                                                       (5, 2, 0.0, 1, 0.0)]
    dev = resolve_device(args.device)
    where = card(dev)
    log(f"device {dev} ({where}); workload {args.workload}; exact against {points}")
    t0 = time.perf_counter()
    b = build(args.workload, dev)
    log(f"built in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    exact = (1, 1, 0.0, 1, 0.0)  # every override at 1: the exact steps
    lat_exact, vid_exact = run(b, exact)
    log(f"exact run: {time.perf_counter() - t0:.1f} s (first run: kernel builds included)")
    if args.time:
        print(json.dumps({"metric": "approx_deviation_exact", "workload": args.workload,
                          "sec_per_video": timed(b, exact), "card": where}), flush=True)
    for point in points:
        ku, kg, w, ks, ws = point
        t0 = time.perf_counter()
        lat, vid = run(b, point)
        rel_l2 = float(np.linalg.norm(lat - lat_exact) / np.linalg.norm(lat_exact))
        ps = float(np.mean([min(psnr(a, e), 99.0) for a, e in zip(vid, vid_exact)]))
        ss = float(np.mean([ssim(a, e) for a, e in zip(vid, vid_exact)]))
        log(f"K_u={ku} K_g={kg} w={w} K_s={ks} w_s={ws}: rel_l2={rel_l2:.4f} "
            f"psnr={ps:.2f} ssim={ss:.4f} ({time.perf_counter() - t0:.1f} s)")
        rec = {"metric": f"approx_deviation_uncond{ku}_guidance{kg}{point_tag(w, ks, ws)}",
               "workload": args.workload, "latent_rel_l2": rel_l2, "decoded_psnr_db": ps,
               "decoded_ssim": ss, "card": where}
        if args.time:
            rec["sec_per_video"] = timed(b, point)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
