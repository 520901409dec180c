"""The runtime: checkpoints -> prompts -> motion representation -> mp4.

Port of ``motionclone_tpu/pipeline/runner.py``: model loading from a
diffusers-layout directory plus the workload's motion module, DreamBooth
checkpoint, adapter LoRA and, for the i2v workloads (``controlnet_path``
set), the SparseCtrl controlnet; prompt encoding; per example, extraction
(cached on disk, with a meta record that invalidates entries extracted
under other settings), guided sampling, the decode to uint8 on the device
and the mp4, named as the reference names it.  With a controlnet both
extraction and sampling are conditioned: extraction on the reference
video's own frames at ``image_index`` (their latents for the RGB flavour,
their pixels in [0, 1] for the sketch flavour), sampling on the example's
condition images (VAE-encoded with the ``CN_IMAGE_POSTERIOR`` draw of the
seed for the RGB flavour, pixels for the sketch flavour).  The
compute runs in :class:`~motionclone_tpu_torch.pipeline.motionclone.MotionClonePipeline`
on ``device`` (CUDA unless the caller asks for the CPU), exact or through
the approx caches; with ``weights_cache`` the loaded state dicts come from
``weights/cache.py`` on a warm start, and ``run_example(resume=True)``
continues an interrupted sampling run from its last finished chunk.

A directory with ``text_encoder_2/`` is SDXL's (``unet/config.json``
then gives its three levels, per-level heads and depths and the
``text_time`` embedding; the workload's model config its motion modules,
schedule and ``guided_recompute``): both towers give their penultimate
state, the second its pooled text, its ``tokenizer_2/`` pads with the pad
token it names, and a prompt's embedding is the pipeline's
``Conditioning`` (its size and crop ids those of the workload's video).

Under a multi-device layout (``frame_shard``, ``cfg_pair``; one process
per rank under torchrun, ``parallel/frames.Layout``) every rank of a video
loads the same weights and runs the same example: the video's lead rank
(its rank 0) decides whether the cached motion representation is used and
tells the others, writes the representation gathered over every query
frame, gathers the latents, decodes them and writes the one mp4; a
weights-cache miss is written by the lead alone while the others wait.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from motionclone_tpu_torch.config import Example, InferenceConfig, load_model_config, load_yaml
from motionclone_tpu_torch.diffusion.guidance import (
    load_motion_representation,
    load_motion_representation_meta,
    save_motion_representation,
)
from motionclone_tpu_torch.io.tokenizer import ClipTokenizer
from motionclone_tpu_torch.io.video import load_condition_images, preprocess_video, write_video
from motionclone_tpu_torch.models.clip_text import CLIPTextModel
from motionclone_tpu_torch.models.sparse_controlnet import (
    SparseControlNetConfig,
    SparseControlNetModel,
    scatter_condition,
)
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
from motionclone_tpu_torch.models.unet_blocks import match_guidance
from motionclone_tpu_torch.models.vae import AutoencoderKL
from motionclone_tpu_torch.parallel.frames import Layout
from motionclone_tpu_torch.pipeline.motionclone import (
    Conditioning,
    MotionClonePipeline,
    resolve_device,
)
from motionclone_tpu_torch.utils import rng, trace
from motionclone_tpu_torch.weights.load import (
    apply_unet_diffusers_config,
    assemble_state_dicts,
    clip_config_from_dir,
    has_second_tower,
    load_into,
    resolve_diffusers_module_path,
    vae_config_from_dir,
)
from motionclone_tpu_torch.weights.cache import cache_key, load_params, save_params


def motion_rep_meta(cfg: InferenceConfig, seed_motion: int) -> dict:
    """The settings a motion representation depends on: the disk cache's
    validity record (saved into the .npz, compared before reuse)."""
    return {
        "height": cfg.height,
        "width": cfg.width,
        "video_length": cfg.video_length,
        "guidance_blocks": list(cfg.motion_guidance_blocks),
        "add_noise_step": cfg.add_noise_step,
        "seed_motion": seed_motion,
    }


def locate_cached_rep(motion_rep_dir: str, stem: str, meta: dict
                      ) -> Tuple[str, Optional[str]]:
    """(save path, usable cached path or None) for a video stem.  An
    ``.npz`` is reused only when its meta matches; a reference ``.pt`` /
    ``.pth`` carries none and is trusted as it is (checked on load)."""
    npz = os.path.join(motion_rep_dir, stem + ".npz")
    if os.path.exists(npz):
        return npz, (npz if load_motion_representation_meta(npz) == meta else None)
    for ext in (".pt", ".pth"):
        alt = os.path.join(motion_rep_dir, stem + ext)
        if os.path.exists(alt):
            return alt, alt
    return npz, None


def _validate_motion_representation(rep, path: str, cfg: InferenceConfig) -> None:
    """Raise an actionable error when a representation file does not fit the
    configuration (instead of a shape error deep in sampling)."""
    if not rep:
        raise ValueError(f"{path}: empty motion representation")
    blocks = tuple(cfg.motion_guidance_blocks)
    for name, (values, _indices) in rep.items():
        if not match_guidance(name, blocks):
            raise ValueError(
                f"{path}: module {name!r} does not match the configured "
                f"motion_guidance_blocks {list(blocks)}; re-extract the "
                f"representation or fix the config")
        if values.shape[-2] != cfg.video_length:
            raise ValueError(
                f"{path}: module {name!r} holds {values.shape[-2]} frames; "
                f"the config expects video_length={cfg.video_length}")


def output_name(example: Example, seed: int, positive_prompt: str) -> str:
    """The reference's mp4 name: the video's stem, the prompt with the
    positive suffix, the seed twice (the motion seed and the sampling seed,
    which the reference takes equal)."""
    stem = os.path.splitext(os.path.basename(example.video_path))[0]
    prompt = example.new_prompt + positive_prompt
    return stem + "_" + prompt.strip().replace(" ", "_") + str(seed) + "_" + str(seed) + ".mp4"


def _asset(config_root: str, path: str) -> str:
    return os.path.join(config_root, path) if path else ""


def weights_cache_key(pretrained_model_path: str, infer_cfg: InferenceConfig,
                      dtype: torch.dtype, config_root: str = ".") -> str:
    """The weights cache's key of ``weights.load.assemble_state_dicts`` in
    ``dtype``: every file it reads (the diffusers modules, SDXL's second
    tower among them, and their config.json files, which set the topology,
    the motion module, the DreamBooth checkpoint, the adapter LoRA, the
    controlnet and its YAML, the model config), the dtype's name and the
    LoRA scale."""
    j = lambda p: _asset(config_root, p)
    subs = ("unet", "vae", "text_encoder") + (
        ("text_encoder_2",) if has_second_tower(pretrained_model_path) else ())
    sources = (
        [resolve_diffusers_module_path(pretrained_model_path, sub)
         or os.path.join(pretrained_model_path, sub) for sub in subs]
        + [os.path.join(pretrained_model_path, sub, "config.json") for sub in subs]
        + [j(infer_cfg.motion_module), j(infer_cfg.dreambooth_path),
           j(infer_cfg.adapter_lora_path), j(infer_cfg.controlnet_path),
           j(infer_cfg.controlnet_config), j(infer_cfg.model_config)])
    return cache_key(sources, {"dtype": str(dtype).replace("torch.", ""),
                               "adapter_lora_scale": infer_cfg.adapter_lora_scale})


def check_layout_flags(frame_shard: int, cfg_pair: bool, video_length: int,
                       sweep: bool = False) -> Tuple[int, bool]:
    """The layout flags checked as the JAX runtime (``sweep``: the JAX
    sweep) checks them, before any file is read; returns (frame shards,
    cfg pair), (0, False) to run unsharded."""
    if cfg_pair and not frame_shard and not sweep:
        raise ValueError(
            "cfg_pair composes with --frame-shard here (torchrun --nproc-per-node 2N); "
            "for CFG-pair splitting without frame sharding use the sweep's --cfg-pair "
            "(data, cfg) mode")
    if frame_shard == 1:
        # a 1-wide frames axis adds no parallelism
        if sweep:
            print("frame_shard=1 is a no-op; running the plain data sweep")
            return 0, cfg_pair
        print("frame-shard 1 is a no-op; running unsharded")
        return 0, False
    if frame_shard < 0 or (frame_shard and video_length % frame_shard):
        raise ValueError(f"--frame-shard {frame_shard} must be >= 1 and divide "
                         f"video_length={video_length}")
    return frame_shard, cfg_pair


class MotionCloneRuntime:
    """Loaded weights and the pipeline for one workload config.

    ``device``: "cuda" (the default; raises on a machine without CUDA) or
    "cpu"; ``dtype``: the modules' and latents' dtype (bf16 by default);
    ``attention_impl``: that of :class:`MotionClonePipeline`.  Relative
    asset paths of ``infer_cfg`` are resolved under ``config_root``.  A
    ``controlnet_path`` builds the SparseCtrl controlnet of
    ``controlnet_config`` (``cn_cfg``; None without one).  The approx knobs
    (``uncond_interval``, ``guidance_interval``, ``uncond_extrap``,
    ``step_interval``, ``step_extrap``; ``cli.parse_approx`` gives them from
    ``--approx``) are :class:`MotionClonePipeline`'s.  ``weights_cache``: a
    directory of converted weights (``weights/cache.py``): a hit takes the
    state dicts the loader would hand to the modules (assembled, merged,
    in ``dtype``) from one file, a miss assembles them and writes the
    entry; ``weights_cache_state`` says "hit", "miss" or "off".
    ``load_seconds`` holds the time the weights took from files to modules
    on the device; a miss's write of the entry is not in it, but in
    ``cache_write_seconds``.

    ``frame_shard`` N > 1 splits every video's frames over N ranks and
    ``cfg_pair`` its CFG pair over two: the JAX package's (cfg, frames)
    mesh, here a :class:`~motionclone_tpu_torch.parallel.frames.Layout` of
    torchrun's world, which must hold N (2N with ``cfg_pair``) ranks,
    joined over ``dist_backend``.  As in the JAX package N must divide
    ``video_length``, N = 1 runs unsharded, and ``cfg_pair`` needs
    ``frame_shard``; the port also needs ``use_inflated_groupnorm`` (the
    JAX package falls back to its GSPMD flavour, which the port does not
    have).  ``layout`` gives the layout itself instead (the sweep's
    (data, cfg, frames)); ``self.layout`` is None when unsharded."""

    def __init__(
        self,
        pretrained_model_path: str,
        infer_cfg: InferenceConfig,
        *,
        device="cuda",
        dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "auto",
        config_root: str = ".",
        uncond_interval: int = 1,
        guidance_interval: int = 1,
        uncond_extrap: float = 0.0,
        step_interval: int = 1,
        step_extrap: float = 0.0,
        weights_cache: str = "",
        frame_shard: int = 0,
        cfg_pair: bool = False,
        dist_backend: str = "nccl",
        layout: Optional[Layout] = None,
    ):
        self.device = resolve_device(device)
        self.infer_cfg = infer_cfg
        self.dtype = dtype
        t0 = time.perf_counter()
        if layout is None:
            frame_shard, cfg_pair = check_layout_flags(frame_shard, cfg_pair,
                                                       infer_cfg.video_length)
        frames = layout.frames if layout is not None else max(frame_shard, 1)
        self.unet_cfg, self.sched_cfg = load_model_config(
            os.path.join(config_root, infer_cfg.model_config))
        self.unet_cfg = apply_unet_diffusers_config(self.unet_cfg, pretrained_model_path)
        if frames > 1 and not self.unet_cfg.use_inflated_groupnorm:
            raise ValueError(
                "--frame-shard requires use_inflated_groupnorm (GroupNorm statistics over "
                "all frames would be computed per rank); the GSPMD flavour that the JAX "
                "package falls back to is not ported")
        self.vae_cfg = vae_config_from_dir(pretrained_model_path)
        xl = has_second_tower(pretrained_model_path)
        self.clip_cfg = clip_config_from_dir(pretrained_model_path, penultimate=xl)
        self.clip2_cfg = (clip_config_from_dir(pretrained_model_path, "text_encoder_2",
                                               penultimate=True, projection=True)
                          if xl else None)
        if layout is None and (frame_shard or cfg_pair):
            layout = Layout.from_env(frames=frames, cfg=2 if cfg_pair else 1,
                                     backend=dist_backend, data=1)
        self.layout = layout
        lead = layout is None or layout.is_lead

        if infer_cfg.controlnet_path and not infer_cfg.controlnet_config:
            raise ValueError("controlnet_path is set but controlnet_config is not: "
                             "the controlnet's YAML gives its topology")
        sds, key = None, None
        if weights_cache and not lead:
            layout.video.barrier()  # the lead reads, or writes on a miss, first
        if weights_cache:
            key = weights_cache_key(pretrained_model_path, infer_cfg, dtype, config_root)
            sds = load_params(weights_cache, key)
            required = {"unet", "vae", "text_encoder"} | (
                {"controlnet"} if infer_cfg.controlnet_path else set()) | (
                {"text_encoder_2"} if xl else set())
            if sds is not None and not required.issubset(sds):
                sds = None  # an entry without a required component is a miss
        self.weights_cache_state = "off" if not weights_cache else (
            "miss" if sds is None else "hit")
        self.cache_write_seconds = 0.0
        if sds is None:
            j = lambda p: _asset(config_root, p)
            sds = assemble_state_dicts(
                pretrained_model_path, motion_module_path=j(infer_cfg.motion_module),
                dreambooth_path=j(infer_cfg.dreambooth_path),
                adapter_lora_path=j(infer_cfg.adapter_lora_path),
                adapter_lora_scale=infer_cfg.adapter_lora_scale,
                controlnet_path=j(infer_cfg.controlnet_path))
            if weights_cache:
                sds = {c: {k: v.to(dtype) for k, v in sd.items()} for c, sd in sds.items()}
            if weights_cache and lead:
                t_save = time.perf_counter()
                save_params(weights_cache, key, sds)
                self.cache_write_seconds = time.perf_counter() - t_save
        if weights_cache and lead and layout is not None:
            layout.video.barrier()
        unet = load_into(lambda: UNet3DConditionModel(self.unet_cfg), sds["unet"], dtype, "unet")
        vae = load_into(lambda: AutoencoderKL(self.vae_cfg), sds["vae"], dtype, "vae")
        clip = load_into(lambda: CLIPTextModel(self.clip_cfg), sds["text_encoder"], dtype,
                         "text_encoder")
        clip2 = None if not xl else load_into(lambda: CLIPTextModel(self.clip2_cfg),
                                              sds["text_encoder_2"], dtype, "text_encoder_2")
        controlnet, self.cn_cfg = None, None
        if infer_cfg.controlnet_path:
            cn_yaml = load_yaml(_asset(config_root, infer_cfg.controlnet_config))
            self.cn_cfg = SparseControlNetConfig.from_yaml_dict(
                cn_yaml.get("controlnet_additional_kwargs", {}), self.unet_cfg)
            controlnet = load_into(lambda: SparseControlNetModel(self.cn_cfg),
                                   sds["controlnet"], dtype, "controlnet")
        del sds
        self.tokenizer = ClipTokenizer.from_pretrained(pretrained_model_path,
                                                       subfolder="tokenizer")
        self.tokenizer_2 = (ClipTokenizer.from_pretrained(pretrained_model_path, "tokenizer_2")
                            if xl else None)
        self.pipeline = MotionClonePipeline(
            self.unet_cfg, self.sched_cfg, infer_cfg, unet, vae=vae, text_encoder=clip,
            text_encoder_2=clip2,
            device=self.device, dtype=dtype, attention_impl=attention_impl,
            controlnet=controlnet, uncond_interval=uncond_interval,
            guidance_interval=guidance_interval, uncond_extrap=uncond_extrap,
            step_interval=step_interval, step_extrap=step_extrap,
            frame_group=None if layout is None else layout.frame_group,
            cfg_pair=None if layout is None else layout.pair,
        )
        self._sync()
        self.load_seconds = time.perf_counter() - t0 - self.cache_write_seconds
        self.timings: Dict[str, object] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def is_lead(self) -> bool:
        """Whether this rank decides the caches and writes the outputs of
        its videos (every unsharded runtime does)."""
        return self.layout is None or self.layout.is_lead

    def lead_decides(self, value):
        """The lead's ``value`` on every rank of the video (``value``
        itself when unsharded): each rank computes it, the lead's wins."""
        return value if self.layout is None else self.layout.video.broadcast_object(value)

    def prepare_motion_rep(self, rep) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """A whole video's representation -> this rank's share of it on the
        device (its query frames under a frame group)."""
        return self.pipeline.local_motion_rep(
            {k: (v.to(self.device), i.to(self.device)) for k, (v, i) in rep.items()})

    # -- text -------------------------------------------------------------

    def _tokenize(self, texts, tokenizer: Optional[ClipTokenizer] = None) -> torch.Tensor:
        """One padded id batch (B, 77) for a str or a sequence of str."""
        tokenizer = tokenizer or self.tokenizer
        if isinstance(texts, str):
            texts = [texts]
        ids = np.concatenate([
            tokenizer.encode_padded(t, max_length=tokenizer.model_max_length)
            for t in texts
        ])
        return torch.from_numpy(ids.astype(np.int64))

    def _text(self, texts):
        """The text encoders' embedding of ``texts``: CLIP's, or with a
        second tower the :class:`Conditioning` of both."""
        if self.tokenizer_2 is None:
            return self.pipeline.encode_text(self._tokenize(texts))
        return self.pipeline.encode_text((self._tokenize(texts),
                                          self._tokenize(texts, self.tokenizer_2)))

    def encode_prompt(self, prompt, negative_prompt="", num_videos_per_prompt: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(uncond, cond) CLIP embeddings, each (B * num_videos, 77, hidden)
        (with a second tower, each a ``Conditioning`` of as many rows).
        ``prompt``: a str or a list of str; ``negative_prompt``: a str (for
        every prompt) or a list as long as the prompts; each embedding is
        repeated ``num_videos_per_prompt`` times in a row."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        if isinstance(negative_prompt, str):
            negatives = [negative_prompt] * len(prompts)
        else:
            negatives = list(negative_prompt)
            if len(negatives) != len(prompts):
                raise ValueError(
                    f"negative_prompt has batch size {len(negatives)}, but prompt has "
                    f"batch size {len(prompts)}: they must match")
        cond, uncond = self._text(prompts), self._text(negatives)
        if num_videos_per_prompt > 1:
            n = num_videos_per_prompt
            cond, uncond = (Conditioning.of(e).repeat(n) if self.tokenizer_2 is not None
                            else e.repeat_interleave(n, dim=0) for e in (cond, uncond))
        return uncond, cond

    # -- latents ----------------------------------------------------------

    def encode_video(self, video: np.ndarray, seed,
                     domain: int = rng.VAE_POSTERIOR) -> torch.Tensor:
        """Pixels (F, H, W, 3) in [-1, 1] -> scaled latents (1, F, h, w, 4)
        with a posterior draw in ``domain`` of ``seed``; a batch (B, F, H,
        W, 3) takes one seed per example."""
        return self.pipeline.encode_video(torch.from_numpy(np.ascontiguousarray(video)), seed,
                                          domain)

    def _condition(self, frames: torch.Tensor, image_index, scale: float):
        """``cn_cond`` for the pipeline: condition frames (1, N, H', W', C)
        scattered to ``image_index`` of the video, with their mask."""
        cond, mask = scatter_condition(frames.to(self.dtype), tuple(image_index),
                                       self.infer_cfg.video_length)
        return cond, mask, float(scale)

    def sampling_condition(self, example: Example, seed: int, scale: float,
                           config_root: str = "."):
        """``cn_cond`` for sampling: the example's condition images at the
        video's size, VAE-encoded with the seed's ``CN_IMAGE_POSTERIOR``
        draw (the simplified, RGB embedding) or as pixels in [0, 1]."""
        cfg = self.infer_cfg
        paths = [os.path.join(config_root, p) for p in example.condition_image_paths]
        imgs01 = load_condition_images(paths, cfg.height, cfg.width)
        if self.cn_cfg.use_simplified_condition_embedding:
            frames = self.encode_video(imgs01 * 2.0 - 1.0, seed, rng.CN_IMAGE_POSTERIOR)
        else:
            frames = torch.from_numpy(imgs01)[None]
        return self._condition(frames, example.image_index, scale)

    def extraction_condition(self, example: Example, video: np.ndarray,
                             video_latents: torch.Tensor, scale: float):
        """``cn_cond`` for extraction, from the reference video itself: its
        latents at ``image_index`` (the simplified, RGB embedding) or its
        pixels there in [0, 1]."""
        idx = list(example.image_index)
        if self.cn_cfg.use_simplified_condition_embedding:
            frames = video_latents[:, idx]
        else:
            frames = torch.from_numpy((video[None, idx] + 1.0) / 2.0)
        return self._condition(frames, idx, scale)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """Latents -> uint8 RGB frames (F, H, W, 3).  The [-1, 1] -> uint8
        conversion runs on the device, so one byte per pixel is copied to
        the host."""
        video = self.pipeline.decode_latents(latents)
        video01 = (video.float() / 2 + 0.5).clamp(0.0, 1.0)
        return torch.round(video01 * 255.0).to(torch.uint8).cpu().numpy()

    def sample_timed(self, uncond_emb, cond_emb, rep, seed, cn_cond, resume_path,
                     timings: Dict[str, object], log, resume_tag: str = "") -> torch.Tensor:
        """``pipeline.sample_latents`` (one seed, or one per example of a
        batch) with each step timed from the program's step record
        (``utils/trace.py``): fills ``timings["sample"]`` (wall seconds), the
        milliseconds of each guided and vanilla step, full and skip steps
        apart, and ``passes_ms``, the milliseconds of each pass of each step
        keyed ``<guided|vanilla>/<span>`` (``controlnet``, ``unet_plain``,
        ``unet_guided_fwd``, ``unet_guided_bwd``), and logs their medians.
        On a card the times are the device's, between CUDA events read
        after the one synchronisation at the end, so the host never waits
        inside the loop; on the CPU the host's.  With recording off
        (``trace.set_enabled(False)``) the lists are empty."""
        cfg = self.infer_cfg
        cuda = self.device.type == "cuda"
        before = trace.last_run()
        self._sync()
        t0 = time.perf_counter()
        latents = self.pipeline.sample_latents(
            uncond_emb, cond_emb, rep, seed=seed, cn_cond=cn_cond, resume_path=resume_path,
            resume_tag=resume_tag)
        self._sync()
        timings["sample"] = time.perf_counter() - t0
        run = trace.last_run()
        ms = lambda span: span.device_ms if cuda else span.host_ns / 1e6
        steps = {key: [] for key in ("guided_ms", "guided_skip_ms", "vanilla_ms",
                                     "vanilla_skip_ms")}
        passes: Dict[str, list] = {}
        for step in (run.steps if run is not None and run is not before else ()):
            kind = "guided" if step.attrs["guided"] else "vanilla"
            steps[kind + ("_ms" if step.attrs["full"] else "_skip_ms")].append(ms(step))
            for child in step.children:
                passes.setdefault(f"{kind}/{child.name}", []).append(ms(child))
        timings.update(steps, passes_ms=passes)
        median = lambda ms: f"{statistics.median(ms):.1f}" if ms else "-"
        log(f"guided sampling ({cfg.inference_steps} steps, {cfg.guidance_steps} guided): "
            f"{timings['sample']:.1f}s; median ms per guided step "
            f"{median(steps['guided_ms'])} (skip steps {median(steps['guided_skip_ms'])}), "
            f"per vanilla step {median(steps['vanilla_ms'])} "
            f"(skip steps {median(steps['vanilla_skip_ms'])}); guided step's passes: "
            + ", ".join(f"{name} {median(passes.get('guided/' + name, []))}"
                        for name in ("controlnet", "unet_plain", "unet_guided_fwd",
                                     "unet_guided_bwd")))
        return latents

    def write_latents(self, path: str, latents: torch.Tensor) -> None:
        """Decode one example's latents (1, F, h, w, 4) and write the mp4."""
        write_video(path, self.decode_latents(latents), fps=8)

    # -- one example ------------------------------------------------------

    def run_example(
        self,
        example: Example,
        *,
        motion_rep_dir: str,
        output_dir: str,
        default_seed: int = 2025,
        config_root: str = ".",
        verbose: bool = True,
        resume: bool = False,
    ) -> str:
        """Extraction (or the cached representation), guided sampling,
        decode and mp4 for one JSONL example; returns the mp4's path.
        ``timings`` then holds the phases' wall seconds (``text``,
        ``extract`` when it ran, ``condition`` with a controlnet, ``sample``,
        ``decode_write``), ``weights_cache`` (hit, miss or off) and the
        milliseconds of each guided and vanilla step, full steps and the
        step cache's skip steps (DDIM only) apart (``guided_ms``,
        ``guided_skip_ms``, ``vanilla_ms``, ``vanilla_skip_ms``) and of their
        passes (``passes_ms``), from the program's step record
        (:meth:`sample_timed`); with ``verbose`` each phase prints a line.
        ``resume``: the sampling loop's latents are checkpointed after each
        chunk to ``output_dir/.resume_<mp4 name>.npz``, and a rerun
        continues from the last finished chunk (the file goes when sampling
        ends)."""
        cfg = self.infer_cfg
        timings: Dict[str, object] = {"text": 0.0, "weights_cache": self.weights_cache_state}
        self.timings = timings
        os.makedirs(motion_rep_dir, exist_ok=True)
        os.makedirs(output_dir, exist_ok=True)

        def log(msg):
            if verbose and self.is_lead:
                print(f"[{example.video_path}] {msg}", flush=True)

        def encode_prompt(*args):
            t = time.perf_counter()
            out = self.encode_prompt(*args)
            self._sync()
            timings["text"] += time.perf_counter() - t
            return out

        seed_motion = example.seed if example.seed is not None else default_seed
        video_path = os.path.join(config_root, example.video_path)
        stem = os.path.splitext(os.path.basename(example.video_path))[0]
        # the JAX runtime appends the positive prompt to every new prompt
        new_prompt = example.new_prompt + cfg.positive_prompt
        conditioned = self.cn_cfg is not None
        if conditioned and not example.condition_image_paths:
            raise ValueError(f"{example.video_path}: the workload has a controlnet but the "
                             f"example has no condition_image_paths")
        cn_scale = (example.controlnet_scale if example.controlnet_scale is not None
                    else cfg.controlnet_scale)

        # 1. the motion representation, cached on disk under the video stem
        rep_meta = motion_rep_meta(cfg, seed_motion)
        rep_path, cached = self.lead_decides(locate_cached_rep(motion_rep_dir, stem, rep_meta))
        if cached is None:
            if os.path.exists(rep_path):
                log(f"cached {os.path.basename(rep_path)} was extracted under "
                    f"different settings; re-extracting")
            t0 = time.perf_counter()
            video = preprocess_video(video_path, cfg.height, cfg.width, cfg.video_length)
            video_latents = self.encode_video(video, seed_motion)
            uncond_emb, _ = encode_prompt("", "")
            cn_cond = (self.extraction_condition(example, video, video_latents, cn_scale)
                       if conditioned else None)
            rep = self.pipeline.gather_motion_rep(self.pipeline.extract_motion_representation(
                video_latents, uncond_emb, seed=seed_motion, cn_cond=cn_cond))
            # what the file holds: f32 values, uint8 indices, on the host
            rep = {k: (v.float().cpu(), i.cpu()) for k, (v, i) in rep.items()}
            if self.is_lead:
                save_motion_representation(rep_path, rep, meta=rep_meta)
            timings["extract"] = time.perf_counter() - t0
            log(f"motion representation extracted: {timings['extract']:.1f}s")
        else:
            log(f"motion representation reused from {cached}")
            rep = load_motion_representation(rep_path)
        _validate_motion_representation(rep, rep_path, cfg)
        rep = self.prepare_motion_rep(rep)

        # 2. guided sampling; the reference seeds it with seed_motion
        seed = seed_motion
        uncond_emb, cond_emb = encode_prompt(new_prompt, cfg.negative_prompt)
        cn_cond = None
        if conditioned:
            t0 = time.perf_counter()
            cn_cond = self.sampling_condition(example, seed, cn_scale, config_root)
            self._sync()
            timings["condition"] = time.perf_counter() - t0
            log(f"condition images: {timings['condition']:.2f}s")
        out_name = output_name(example, seed, cfg.positive_prompt)
        out_path = os.path.join(output_dir, out_name)
        resume_path = (os.path.join(output_dir, ".resume_" + out_name + ".npz")
                       if resume else None)
        latents = self.sample_timed(uncond_emb, cond_emb, rep, seed, cn_cond, resume_path,
                                    timings, log)

        # 3. decode and write the video (the lead, from every rank's frames)
        latents = self.pipeline.gather_latents(latents)
        if self.is_lead:
            t0 = time.perf_counter()
            self.write_latents(out_path, latents)
            timings["decode_write"] = time.perf_counter() - t0
            log(f"decode + write: {timings['decode_write']:.1f}s")
        return out_path
