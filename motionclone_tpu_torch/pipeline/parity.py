"""Output parity against the reference's committed sample videos.

Port of ``motionclone_tpu/pipeline/parity.py``.  The reference repository
validates itself with two committed mp4s (``generated_videos/``): the i2v
RGB "Dog, lying on the grass" and the i2v sketch "Lion, walks in the
forest", both made with seed 76739, the default of its i2v driver.
:func:`run_parity` runs those workloads from the shipped configs and
examples with that seed on the port's runtime, scores each produced mp4
against the reference's mp4 of the same name (PSNR and SSIM,
``utils/metrics.py``) and returns one summary record.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

from motionclone_tpu_torch.config import load_examples, load_inference_config
from motionclone_tpu_torch.utils.metrics import compare_videos

# the workloads whose outputs the reference committed: (config, examples)
# under the config root
WORKLOADS = {
    "rgb": ("configs/i2v_rgb.yaml", "configs/i2v_rgb.jsonl"),
    "sketch": ("configs/i2v_sketch.yaml", "configs/i2v_sketch.jsonl"),
}

# the seed of the committed outputs (the reference's i2v driver's default)
REFERENCE_SEED = 76739


def _default_runtime_factory(pretrained_model_path, cfg, **kwargs):
    from motionclone_tpu_torch.pipeline.runner import MotionCloneRuntime

    return MotionCloneRuntime(pretrained_model_path, cfg, **kwargs)


def run_parity(
    reference_outputs: str,
    output_dir: str,
    *,
    config_root: str = ".",
    pretrained_model_path: str = "models/StableDiffusion",
    workloads: Sequence[str] = ("rgb", "sketch"),
    width: int = 512,
    height: int = 512,
    video_length: int = 16,
    attention_impl: str = "auto",
    runtime_factory: Optional[Callable] = None,
    motion_rep_dir: Optional[str] = None,
    verbose: bool = True,
    device: str = "cuda",
) -> Dict:
    """Generate the workloads' examples (seed 76739 where an example names
    none) and score each mp4 against the one of the same name in
    ``reference_outputs``.  Returns ``{"pairs": [{name, matched, psnr_mean,
    ssim_mean, ...}], "generated", "matched", "psnr_mean", "ssim_mean"}``
    (the means over the matched pairs, None without one).  The default
    runtime is the port's :class:`MotionCloneRuntime` on ``device``."""
    factory = runtime_factory or _default_runtime_factory
    motion_rep_dir = motion_rep_dir or os.path.join(output_dir, "motion_rep")
    os.makedirs(output_dir, exist_ok=True)

    produced = []
    for name in workloads:
        cfg_path, examples_path = WORKLOADS[name]
        cfg = load_inference_config(os.path.join(config_root, cfg_path), width=width,
                                    height=height, video_length=video_length)
        examples = load_examples(os.path.join(config_root, examples_path))
        runtime = factory(pretrained_model_path, cfg, config_root=config_root,
                          attention_impl=attention_impl, device=device)
        for example in examples:
            produced.append(runtime.run_example(
                example, motion_rep_dir=motion_rep_dir, output_dir=output_dir,
                default_seed=REFERENCE_SEED, config_root=config_root, verbose=verbose))

    ref_names = {n for n in os.listdir(reference_outputs) if n.endswith(".mp4")}
    pairs = []
    for out in produced:
        base = os.path.basename(out)
        if base not in ref_names:
            pairs.append({"name": base, "matched": False})
            continue
        rec = compare_videos(out, os.path.join(reference_outputs, base))
        rec["name"] = base
        rec["matched"] = True
        pairs.append(rec)

    scored = [p for p in pairs if p["matched"]]
    mean = lambda key: sum(p[key] for p in scored) / len(scored) if scored else None
    return {"pairs": pairs, "generated": len(produced), "matched": len(scored),
            "psnr_mean": mean("psnr_mean"), "ssim_mean": mean("ssim_mean")}
