"""Example sweeps: several examples batched through one sampling pass.

Port of ``motionclone_tpu/pipeline/sweep.py``, the data path.  Examples are
independent (their own seeds, prompts and reference videos), so a sweep
splits them into batches of ``num_devices`` examples along the leading
axis and runs each batch as one pass of the same code a single example
takes.  ``num_devices`` keeps the JAX package's meaning, examples per
sampling pass (its ``data`` axis's size); a port process drives one card,
so a pass is a batch of ``num_devices`` examples on that card (1 by
default).  Several cards run share-nothing ranks, each its own stride of
the examples (``parallel/distributed.py``).  Under a multi-device layout
(the JAX package's (data, [cfg,] frames) mesh, ``runtime.layout``) the
runtime's ranks sample each batch together, frame-sharded and/or with the
CFG pair split, and the batch's lead rank decides the representation cache
and writes the representations and the mp4s, as ``run_example`` does.

Per batch, as the JAX sweep does:

* the motion-representation cache: when every example's ``.npz`` (or
  reference ``.pt``) is there with matching meta, preprocessing, the VAE
  encode and extraction are skipped; else the batch is extracted and each
  real example's representation saved with its meta (``runner.
  motion_rep_meta``);
* one CLIP call on 2B + 1 rows (the prompts with the positive suffix, the
  negative prompt B times, the empty prompt for extraction);
* the noise of every draw (the VAE posterior, the extraction noise, the
  initial latents) per example in that example's seed domains;
* with a controlnet (i2v): each example's extraction and sampling
  conditions, its ``controlnet_scale`` as a (B, 1, 1, 1, 1) scale, and one
  count of condition images over the sweep;
* ``resume``: the batch's sampling loop is checkpointed after each chunk
  as ``.resume_sweep_<tag>.npz`` under the output directory, the tag being
  the first 16 hex digits of the sha1 of the batch's
  ``video_path:new_prompt:seed`` (the JAX package's file name);
* the last batch is padded by repeating its final example, whose outputs
  are discarded; mp4s are named as the reference names them.

The approx caches (``--approx``) are the runtime's pipeline's, so every
sweep runs them.  ``runtime.timings`` holds each batch's record in
``run_example``'s keys, the last batch's after the call.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from motionclone_tpu_torch.config import Example
from motionclone_tpu_torch.diffusion.guidance import (
    load_motion_representation,
    save_motion_representation,
)
from motionclone_tpu_torch.io.video import preprocess_video
from motionclone_tpu_torch.pipeline.motionclone import Conditioning
from motionclone_tpu_torch.pipeline.runner import (
    _validate_motion_representation,
    locate_cached_rep,
    motion_rep_meta,
    output_name,
)


def pad_to_multiple(n: int, m: int) -> int:
    return (-n) % m


def batch_examples(examples: Sequence[Example], batch_size: int
                   ) -> List[Tuple[List[Example], int]]:
    """Split into batches of ``batch_size``; the last batch is padded by
    repeating its final example (padding outputs are discarded).
    Returns [(examples_incl_padding, n_real)]."""
    batches = []
    for i in range(0, len(examples), batch_size):
        chunk = list(examples[i: i + batch_size])
        n_real = len(chunk)
        chunk += [chunk[-1]] * pad_to_multiple(n_real, batch_size)
        batches.append((chunk, n_real))
    return batches


def resume_tag(chunk: Sequence[Example], seeds: Sequence[int]) -> str:
    """The batch's resume tag: a hash of its examples and seeds."""
    return hashlib.sha1("|".join(f"{e.video_path}:{e.new_prompt}:{s}"
                                 for e, s in zip(chunk, seeds)).encode()).hexdigest()[:16]


def _batched_condition(conditions, scales, dtype):
    """Per-example ``cn_cond``s -> one batched (cond, mask, scale), the
    scale a (B, 1, 1, 1, 1) tensor of each example's."""
    cond = torch.cat([c for c, _, _ in conditions])
    mask = torch.cat([m for _, m, _ in conditions])
    scale = torch.tensor(scales, dtype=dtype).reshape(-1, 1, 1, 1, 1)
    return cond, mask, scale


def run_sweep(
    runtime,
    examples: Sequence[Example],
    *,
    motion_rep_dir: str,
    output_dir: str,
    default_seed: int = 2025,
    config_root: str = ".",
    num_devices: int = 0,
    resume: bool = False,
    verbose: bool = True,
) -> List[str]:
    """Run every example in batches of ``num_devices`` (0: 1) on
    ``runtime`` (a :class:`~motionclone_tpu_torch.pipeline.runner.
    MotionCloneRuntime`); returns the written mp4 paths in the examples'
    order.  An i2v sweep needs the same count of condition images in every
    example (mixed counts make ragged condition batches: run those
    serially)."""
    if num_devices < 0:
        raise ValueError(f"num_devices must be >= 0 (0: 1), got {num_devices}")
    cfg = runtime.infer_cfg
    os.makedirs(motion_rep_dir, exist_ok=True)
    os.makedirs(output_dir, exist_ok=True)
    if runtime.cn_cfg is not None:
        counts = {len(e.condition_image_paths or ()) for e in examples}
        if len(counts) > 1:
            raise ValueError(
                "i2v sweep needs a uniform condition-image count per "
                f"example, got {sorted(counts)}; run mixed examples serially")
        if 0 in counts:
            raise ValueError("the workload has a controlnet but the examples have no "
                             "condition_image_paths")
    out_paths: List[str] = []
    for chunk, n_real in batch_examples(examples, num_devices or 1):
        out_paths += _run_batch(runtime, chunk, n_real, cfg, motion_rep_dir, output_dir,
                                default_seed, config_root, resume, verbose)
    return out_paths


def _run_batch(runtime, chunk, n_real, cfg, motion_rep_dir, output_dir, default_seed,
               config_root, resume, verbose) -> List[str]:
    pipe, b = runtime.pipeline, len(chunk)
    use_cn = runtime.cn_cfg is not None
    timings: Dict[str, object] = {"text": 0.0, "weights_cache": runtime.weights_cache_state}
    runtime.timings = timings

    def log(msg):
        if verbose and runtime.is_lead:
            print(f"[sweep batch of {b}, {n_real} real] {msg}", flush=True)

    seeds = [e.seed if e.seed is not None else default_seed for e in chunk]
    scales = [e.controlnet_scale if e.controlnet_scale is not None else cfg.controlnet_scale
              for e in chunk]
    stems = [os.path.splitext(os.path.basename(e.video_path))[0] for e in chunk]
    metas = [motion_rep_meta(cfg, s) for s in seeds]

    # 1. the motion-representation cache: a hit only for the whole batch
    rep = None
    hits = runtime.lead_decides([locate_cached_rep(motion_rep_dir, stem, meta)[1]
                                 for stem, meta in zip(stems, metas)])
    if all(hit is not None for hit in hits):
        per_ex = [load_motion_representation(hit) for hit in hits]
        keys = set(per_ex[0])
        if all(set(r) == keys for r in per_ex):
            for r, hit in zip(per_ex, hits):
                _validate_motion_representation(r, hit, cfg)
            rep = {k: (torch.cat([r[k][0] for r in per_ex]), torch.cat([r[k][1] for r in per_ex]))
                   for k in sorted(keys)}
            log(f"motion representations reused from {hits}")

    # 2. one text call: the prompts, the negative prompt B times, ""
    t0 = time.perf_counter()
    emb = Conditioning.of(runtime._text([e.new_prompt + cfg.positive_prompt for e in chunk]
                                        + [cfg.negative_prompt] * b + [""]))
    runtime._sync()
    timings["text"] = time.perf_counter() - t0
    cond_emb, uncond_emb = emb.rows(slice(0, b)), emb.rows(slice(b, 2 * b))

    # 3. VAE encode and extraction, batched (skipped on a full hit)
    if rep is None:
        t0 = time.perf_counter()
        videos = np.stack([preprocess_video(os.path.join(config_root, e.video_path), cfg.height,
                                            cfg.width, cfg.video_length) for e in chunk])
        latents = runtime.encode_video(videos, seeds)
        cn_extract = None
        if use_cn:
            cn_extract = _batched_condition(
                [runtime.extraction_condition(e, videos[i], latents[i: i + 1], scales[i])
                 for i, e in enumerate(chunk)], scales, runtime.dtype)
        rep = pipe.gather_motion_rep(pipe.extract_motion_representation(
            latents, emb.rows(slice(2 * b, None)).repeat(b), seed=seeds, cn_cond=cn_extract))
        # each real example's representation, always as .npz (a user's
        # reference .pt is never overwritten)
        for i in range(n_real if runtime.is_lead else 0):
            save_motion_representation(
                os.path.join(motion_rep_dir, stems[i] + ".npz"),
                {k: (v[i: i + 1], ix[i: i + 1]) for k, (v, ix) in rep.items()},
                meta=metas[i])
        runtime._sync()
        timings["extract"] = time.perf_counter() - t0
        log(f"motion representations extracted: {timings['extract']:.1f}s")
    rep = runtime.prepare_motion_rep(rep)

    # 4. guided sampling of the batch
    cn_cond = None
    if use_cn:
        t0 = time.perf_counter()
        cn_cond = _batched_condition(
            [runtime.sampling_condition(e, s, scale, config_root)
             for e, s, scale in zip(chunk, seeds, scales)], scales, runtime.dtype)
        runtime._sync()
        timings["condition"] = time.perf_counter() - t0
        log(f"condition images: {timings['condition']:.2f}s")
    resume_path, tag = None, ""
    if resume:
        tag = resume_tag(chunk, seeds)
        resume_path = os.path.join(output_dir, f".resume_sweep_{tag}.npz")
    latents = pipe.gather_latents(runtime.sample_timed(
        uncond_emb, cond_emb, rep, seeds, cn_cond, resume_path, timings, log, resume_tag=tag))

    # 5. decode and write the real examples (the lead)
    t0 = time.perf_counter()
    paths = [os.path.join(output_dir, output_name(chunk[i], seeds[i], cfg.positive_prompt))
             for i in range(n_real)]
    if runtime.is_lead:
        for i, path in enumerate(paths):
            runtime.write_latents(path, latents[i: i + 1])
        timings["decode_write"] = time.perf_counter() - t0
        log(f"decode + write: {timings['decode_write']:.1f}s")
    return paths
