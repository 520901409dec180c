"""The MotionClone algorithm: extraction, guided and vanilla DDIM steps.

Port of the exact path of ``motionclone_tpu/pipeline/motionclone.py``
(``make_sampling_fns``, ``make_controlnet_apply`` and
``MotionClonePipeline``), unsharded or frame-sharded:

* extraction is one truncated UNet forward (up to the last guidance block)
  on the reference latents noised to ``add_noise_step``, then top-1
  sparsification of the guidance blocks' temporal-attention probabilities;
* a guided step runs the unconditional forward without grad, then the
  conditional forward under autograd and ``torch.autograd.grad`` of the
  motion-guidance loss with respect to the latents (up blocks after the
  last guidance block run without grad), scales the gradient by the step's
  warm-up/cool-down ramp, combines CFG as ``cond + s * (cond - uncond)``
  and takes the DDIM step with the gradient as score;
* a vanilla step is one batch-2 CFG forward and a DDIM step;
* ``sample`` runs the guided phase then the vanilla phase as a Python loop.

With a ``controlnet`` (``models/sparse_controlnet.py``, the i2v workloads)
each function takes ``cn_cond = (cond, mask, scale)``: the frame-scattered
condition, its mask (``scatter_condition``) and the conditioning scale, a
Python float; ``cn_cond=None`` means no conditioning.  The controlnet runs
without grad on the path of the passes that are not differentiated, so its
residuals are constants of the guidance gradient, as in the JAX package:
once per sampling step on the CFG pair (batch 2, the condition tiled over
both halves), its residuals split per half for the guided step's two passes
and whole for the vanilla pass; once in extraction, at batch 1 on the noisy
reference latents with the unconditional embedding.

``attention_impl`` picks the path of the passes that are not
differentiated, as the JAX package's ``make_sampling_fns`` does: "auto" is
"fused" on CUDA (the guided step's unconditional pass, the up blocks past
the guidance cut in its conditional pass, and the vanilla pass run the
fused kernels 5-8) and "flash" on the CPU; "flash" keeps every pass on the
unfused path; "fused" on the CPU runs the fused kernels' plain versions.
Extraction and the conditional pass up to the cut stay unfused: they need
the probabilities and the gradient.

``frame_group`` (``parallel/frames.py``) is the JAX package's
``frame_shard_map`` over its ``frames`` axis: each rank holds video frames
[rank * f, (rank + 1) * f), runs everything per frame on them, and gathers
the motion modules' keys and values over the group.  ``extract`` takes the
full latents and noise and returns the rank's share of the motion
representation (its query frames, axis 3); ``guided_step``, ``vanilla_step``
and ``sample`` take and return the rank's latents.  Each rank differentiates
its partial guidance loss; ``guided_step`` returns the loss summed over the
ranks, outside autograd.  Sharding needs ``use_inflated_groupnorm`` and a
``video_length`` that the group's size divides; a group of size 1 runs
unsharded.  A controlnet under a group of more than one rank raises: the
frame-sharded controlnet is ROADMAP.md queue 1 item 7.

The lower-level functions take explicit noise and latents, so tests can
feed numpy inputs.  Entry points run on CUDA unless ``device="cpu"`` is
passed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from motionclone_tpu_torch.config import InferenceConfig, NoiseScheduleConfig, UNet3DConfig
from motionclone_tpu_torch.diffusion.ddim import (
    add_noise,
    build_timesteps,
    ddim_step,
    make_ddim_params,
    prev_timesteps,
)
from motionclone_tpu_torch.diffusion.guidance import (
    motion_guidance_loss,
    ramp_scales,
    sparsify_top1,
)
from motionclone_tpu_torch.models.sparse_controlnet import SparseControlNetModel
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
from motionclone_tpu_torch.parallel.frames import FrameGroup
from motionclone_tpu_torch.utils import rng

MotionRep = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
# (frame-scattered condition, its mask, conditioning scale)
CnCond = Tuple[torch.Tensor, torch.Tensor, float]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA on a machine without it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the port on the CPU (with the kernels' plain PyTorch versions)"
        )
    return dev


def guidance_cut_index(guidance_blocks: Tuple[str, ...]) -> int:
    """Index of the last up block needed for the guidance features: the
    trailing integer of the last entry."""
    return int(guidance_blocks[-1].rsplit(".", 1)[-1])


@dataclasses.dataclass(frozen=True)
class SamplingFns:
    extract: Callable[..., MotionRep]
    guided_step: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    vanilla_step: Callable[..., torch.Tensor]
    sample: Callable[..., torch.Tensor]
    timesteps: np.ndarray
    frame_group: Optional[FrameGroup] = None  # None: unsharded


def resolve_impl(attention_impl: str, device: torch.device) -> str:
    """The implementation of the non-differentiated passes."""
    if attention_impl == "auto":
        return "fused" if device.type == "cuda" else "flash"
    if attention_impl not in ("flash", "fused"):
        raise ValueError(f"unknown attention_impl {attention_impl!r} (auto, flash or fused)")
    return attention_impl


def check_frame_group(
    frame_group: Optional[FrameGroup], unet_cfg: UNet3DConfig,
    infer_cfg: InferenceConfig,
) -> Optional[FrameGroup]:
    """The group to shard over, or None to run unsharded (no group, or one
    of size 1); raises where the JAX package's ``frame_shard_map`` does."""
    if frame_group is None or frame_group.size == 1:
        return None
    if not unet_cfg.use_inflated_groupnorm:
        raise ValueError(
            "frame sharding requires use_inflated_groupnorm (GroupNorm "
            "statistics over all frames would be computed per rank)"
        )
    if infer_cfg.video_length % frame_group.size:
        raise ValueError(
            f"video_length {infer_cfg.video_length} does not split over "
            f"{frame_group.size} frame shards"
        )
    return frame_group


def make_sampling_fns(
    unet: UNet3DConditionModel,
    sched_cfg: NoiseScheduleConfig,
    infer_cfg: InferenceConfig,
    attention_impl: str = "auto",
    frame_group: Optional[FrameGroup] = None,
    controlnet: Optional[SparseControlNetModel] = None,
) -> SamplingFns:
    """Build extract / guided_step / vanilla_step / sample around ``unet``
    (its parameters' device and dtype set where the work runs), sharded
    over ``frame_group``'s ranks when it has more than one, conditioned by
    ``controlnet`` where a ``cn_cond`` is passed."""
    group = check_frame_group(frame_group, unet.cfg, infer_cfg)
    if controlnet is not None and group is not None:
        raise NotImplementedError(
            "a controlnet under frame sharding is ROADMAP.md queue 1 item 7 (the "
            "frame-sharded controlnet); run the i2v workloads unsharded")
    device = unet.conv_in.weight.device
    plain_impl = resolve_impl(attention_impl, device)
    ddim = make_ddim_params(sched_cfg, device)
    guidance = tuple(infer_cfg.motion_guidance_blocks)
    cut = guidance_cut_index(guidance)
    cfg_scale = infer_cfg.cfg_scale
    timesteps = build_timesteps(
        infer_cfg.inference_steps,
        sched_cfg.num_train_timesteps,
        guidance_steps=infer_cfg.guidance_steps,
        guidance_fraction=infer_cfg.guidance_fraction,
        steps_offset=sched_cfg.steps_offset,
        spacing="uneven",
    )
    t_prev = prev_timesteps(timesteps)
    ramps = ramp_scales(
        infer_cfg.guidance_steps, infer_cfg.warm_up_steps, infer_cfg.cool_up_steps
    )
    g = infer_cfg.guidance_steps

    def residuals(latents, t: int, emb, cn_cond: Optional[CnCond]):
        """The controlnet's (down, mid) residuals for ``latents``, without
        grad; the condition is tiled over a batch twice its own (the CFG
        pair).  None without a controlnet or a condition."""
        if controlnet is None or cn_cond is None:
            return None
        cond, mask, scale = cn_cond
        if latents.shape[0] == 2 * cond.shape[0]:
            cond, mask = torch.cat([cond, cond]), torch.cat([mask, mask])
        with torch.no_grad():
            return controlnet(latents, t, emb, cond, mask, scale, impl=plain_impl)

    def residual_kwargs(res, sl: slice = slice(None)):
        # the UNet's keyword arguments for the residuals' batch rows ``sl``
        if res is None:
            return {}
        down, mid = res
        return dict(down_block_residuals=tuple(d[sl] for d in down),
                    mid_block_residual=mid[sl])

    def extract(video_latents, noise, uncond_emb, cn_cond: Optional[CnCond] = None
                ) -> MotionRep:
        if group is not None:
            if video_latents.shape[1] != infer_cfg.video_length:
                raise ValueError(
                    f"extract takes the full {infer_cfg.video_length} frames, "
                    f"got {video_latents.shape[1]}"
                )
            video_latents, noise = group.local_frames(video_latents), group.local_frames(noise)
        with torch.no_grad():
            noisy = add_noise(ddim, infer_cfg.add_noise_step, video_latents, noise)
            res = residuals(noisy, infer_cfg.add_noise_step, uncond_emb, cn_cond)
            _, probs = unet(noisy, infer_cfg.add_noise_step, uncond_emb,
                            guidance_blocks=guidance, max_up_block=cut,
                            frame_group=group, **residual_kwargs(res))
        return {k: sparsify_top1(p) for k, p in probs.items()}

    def pair_residuals(latents, t: int, uncond_emb, cond_emb, cn_cond):
        # one batch-2 controlnet pass on the CFG pair
        return residuals(torch.cat([latents, latents]), t,
                         torch.cat([uncond_emb, cond_emb]), cn_cond)

    def guided_step(latents, t: int, tp: int, ramp: float, uncond_emb, cond_emb,
                    motion_rep: MotionRep, cn_cond: Optional[CnCond] = None):
        """Returns (new latents, guidance loss)."""
        b = latents.shape[0]
        res = pair_residuals(latents, t, uncond_emb, cond_emb, cn_cond)
        with torch.no_grad():
            uncond_pred, _ = unet(latents, t, uncond_emb, attention_impl=plain_impl,
                                  frame_group=group, **residual_kwargs(res, slice(None, b)))
        with torch.enable_grad():
            leaf = latents.detach().requires_grad_(True)
            cond_pred, probs = unet(leaf, t, cond_emb, guidance_blocks=guidance,
                                    post_guidance_cut=cut,
                                    post_guidance_impl=plain_impl, frame_group=group,
                                    **residual_kwargs(res, slice(b, None)))
            loss = infer_cfg.motion_guidance_weight * motion_guidance_loss(
                probs, motion_rep, group
            )
            (grad,) = torch.autograd.grad(loss, leaf)
        grad = grad * ramp  # the loss ramp scales the score linearly
        cond_pred = cond_pred.detach()
        noise_pred = cond_pred + cfg_scale * (cond_pred - uncond_pred)
        new = ddim_step(ddim, noise_pred, t, tp, latents, score=grad,
                        guidance_scale=1.0)
        loss = loss.detach()
        if group is not None:  # the value: the ranks' partials summed
            loss = group.all_reduce_sum(loss)
        return new, loss

    def vanilla_step(latents, t: int, tp: int, uncond_emb, cond_emb,
                     cn_cond: Optional[CnCond] = None):
        b = latents.shape[0]
        res = pair_residuals(latents, t, uncond_emb, cond_emb, cn_cond)
        with torch.no_grad():
            pred2, _ = unet(torch.cat([latents, latents]), t,
                            torch.cat([uncond_emb, cond_emb]),
                            attention_impl=plain_impl, frame_group=group,
                            **residual_kwargs(res))
        uncond_pred, cond_pred = pred2[:b], pred2[b:]
        noise_pred = cond_pred + cfg_scale * (cond_pred - uncond_pred)
        return ddim_step(ddim, noise_pred, t, tp, latents)

    def sample(init_latents, uncond_emb, cond_emb, motion_rep: MotionRep,
               on_step: Optional[Callable[[int, bool], None]] = None,
               cn_cond: Optional[CnCond] = None):
        """Guided then vanilla phase; ``on_step(index, guided)`` is called
        after each step."""
        latents = init_latents  # init_noise_sigma == 1 for DDIM
        for i, (t, tp) in enumerate(zip(timesteps.tolist(), t_prev.tolist())):
            if i < g:
                latents, _ = guided_step(latents, t, tp, float(ramps[i]),
                                         uncond_emb, cond_emb, motion_rep, cn_cond)
            else:
                latents = vanilla_step(latents, t, tp, uncond_emb, cond_emb, cn_cond)
            if on_step is not None:
                on_step(i, i < g)
        return latents

    return SamplingFns(extract=extract, guided_step=guided_step,
                       vanilla_step=vanilla_step, sample=sample,
                       timesteps=timesteps, frame_group=group)


class MotionClonePipeline:
    """Host-side orchestration: seeds, text and VAE integration.

    ``unet`` (and the optional ``vae`` / ``text_encoder``) are moved to
    ``device`` and ``dtype``; the default is CUDA in bfloat16, and so is the
    optional ``controlnet``.  ``attention_impl``, ``frame_group`` and
    ``controlnet`` are those of :func:`make_sampling_fns`; a ``cn_cond`` is
    moved to the device and dtype before it conditions a pass.  Every noise tensor is drawn by
    ``utils.rng.draw_normal`` in its own domain of the seed (the VAE
    posterior, the extraction noise, the initial latents), so one seed gives
    three independent draws.  Under a frame group every rank draws the
    global noise from the seed and takes its frames, so sharded and
    unsharded runs start from the same tensors; the text encoder and the
    VAE run unsharded (:meth:`gather_latents` before the decode).
    """

    def __init__(
        self,
        unet_cfg: UNet3DConfig,
        sched_cfg: NoiseScheduleConfig,
        infer_cfg: InferenceConfig,
        unet: UNet3DConditionModel,
        *,
        vae=None,
        text_encoder=None,
        device="cuda",
        dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "auto",
        frame_group: Optional[FrameGroup] = None,
        controlnet: Optional[SparseControlNetModel] = None,
    ):
        infer_cfg.validate()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.unet_cfg, self.sched_cfg, self.infer_cfg = unet_cfg, sched_cfg, infer_cfg
        self.unet = unet.to(device=self.device, dtype=dtype).eval()
        self.vae = None if vae is None else vae.to(device=self.device, dtype=dtype).eval()
        self.text_encoder = (
            None if text_encoder is None
            else text_encoder.to(device=self.device, dtype=dtype).eval()
        )
        self.controlnet = (
            None if controlnet is None
            else controlnet.to(device=self.device, dtype=dtype).eval()
        )
        self.fns = make_sampling_fns(self.unet, sched_cfg, infer_cfg, attention_impl,
                                     frame_group, self.controlnet)

    @torch.no_grad()
    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token ids (B, 77) -> text embeddings (B, 77, hidden)."""
        return self.text_encoder(input_ids.to(self.device))

    @torch.no_grad()
    def encode_video(self, video: torch.Tensor, seed: int,
                     domain: int = rng.VAE_POSTERIOR) -> torch.Tensor:
        """Pixels (F, H, W, 3) in [-1, 1] -> scaled latents (1, F, h, w, 4)
        with a posterior draw in ``domain`` of ``seed`` (the reference
        video's by default; the i2v condition images' is
        ``rng.CN_IMAGE_POSTERIOR``)."""
        from motionclone_tpu_torch.models.vae import sample_latents

        x = video.to(device=self.device, dtype=self.dtype)[None]
        mean, logvar = self.vae.encode(x)
        eps = rng.draw_normal(mean.shape, seed, domain, self.device)
        z = sample_latents(mean, logvar, eps)
        return z * self.vae.cfg.scaling_factor

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents (1, F, h, w, 4) -> pixels (F, H, W, 3) in [-1, 1]."""
        z = latents.to(self.dtype) / self.vae.cfg.scaling_factor
        return self.vae.decode(z)[0]

    def gather_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """The full video's latents from each rank's frames (the latents
        themselves when unsharded)."""
        group = self.fns.frame_group
        return latents if group is None else group.gather_frames(latents)

    def _cn_cond(self, cn_cond: Optional[CnCond]) -> Optional[CnCond]:
        if cn_cond is None:
            return None
        cond, mask, scale = cn_cond
        mv = lambda x: x.to(device=self.device, dtype=self.dtype)
        return mv(cond), mv(mask), float(scale)

    def extract_motion_representation(
        self, video_latents: torch.Tensor, uncond_emb: torch.Tensor, seed: int,
        cn_cond: Optional[CnCond] = None,
    ) -> MotionRep:
        """One truncated forward on the full video's latents -> the sparse
        motion representation (the rank's query frames when sharded)."""
        noise = rng.draw_normal(video_latents.shape, seed, rng.EXTRACT_NOISE, self.device)
        return self.fns.extract(video_latents.to(self.dtype), noise.to(self.dtype),
                                uncond_emb.to(self.dtype), self._cn_cond(cn_cond))

    def initial_latents(self, seed: int) -> torch.Tensor:
        """The initial latents drawn from ``seed``: the whole video's noise
        (1, F, h, w, 4), or the rank's frames of it when sharded."""
        cfg = self.infer_cfg
        shape = (1, cfg.video_length, cfg.height // 8, cfg.width // 8,
                 self.unet_cfg.in_channels)
        latents = rng.draw_normal(shape, seed, rng.INIT_LATENTS, self.device).to(self.dtype)
        if self.fns.frame_group is not None:
            latents = self.fns.frame_group.local_frames(latents)
        return latents

    def sample_latents(
        self, uncond_emb: torch.Tensor, cond_emb: torch.Tensor,
        motion_rep: MotionRep, seed: int,
        on_step: Optional[Callable[[int, bool], None]] = None,
        cn_cond: Optional[CnCond] = None,
    ) -> torch.Tensor:
        """Guided DDIM sampling from seeded noise -> final latents (the
        rank's frames when sharded)."""
        latents = self.initial_latents(seed)
        return self.fns.sample(latents, uncond_emb.to(self.dtype),
                               cond_emb.to(self.dtype), motion_rep, on_step=on_step,
                               cn_cond=self._cn_cond(cn_cond))
