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
* ``sample`` runs the guided phase then the vanilla phase as a Python loop,
  in chunks (below), through the cached steps with every flag true on the
  exact schedule; ``guided_step`` and ``vanilla_step`` are the exact steps
  alone, for callers that drive one step;
* ``sample_plain`` is plain AnimateDiff generation without motion guidance
  (the reference's legacy ``AnimationPipeline.__call__``): the diffusers
  "leading" DDIM spacing (``plain_timesteps``), every step a vanilla step,
  in chunks through the same cached steps (the build's uncond and step
  caches act on it; the guidance cache has nothing to act on);
  ``sample_plain_probs`` is its exact schedule that also returns every
  step's temporal-attention probabilities of the guidance blocks from the
  batch-2 CFG forward (the reference's ``save_probs`` dump), copied to the
  host after each chunk.

With a ``controlnet`` (``models/sparse_controlnet.py``, the i2v workloads)
each function takes ``cn_cond = (cond, mask, scale)``: the frame-scattered
condition, its mask (``scatter_condition``) and the conditioning scale, a
Python float or, for a batch of examples, one per example as a (B, 1, 1,
1, 1) tensor (tiled over the CFG pair as the condition is);
``cn_cond=None`` means no conditioning.  The controlnet runs
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
unsharded.  A controlnet runs frame-sharded too (its motion modules gather
over the group); the functions then take the full condition and mask
(``scatter_condition``'s, all F frames) and split them, and a call without
``cn_cond`` raises, as the JAX package's ``_check_smap_cn_cond`` does.

``cfg_pair`` (``parallel/frames.py``'s ``Layout.pair``: this rank and the
rank of the other CFG half at the same frames) is the JAX package's ``cfg``
mesh axis (``guided_step_smap_pair``, ``vanilla_step_smap_pair``, and
``guided_step_pair`` without frame sharding): pair rank 0 runs the
unconditional half, pair rank 1 the conditional one.  A guided step runs
the controlnet at batch B on the half's own embedding, then the
unconditional forward (rank 0) or the conditional forward and backward
(rank 1; JAX's uncond half also runs a backward whose gradient it masks to
zero, which the port skips); one exchange over the pair
(``exchange_pair``) gives every rank both predictions, the conditional
gradient and the loss, and each applies the ramp, CFG and DDIM as the
serial step does.  A vanilla step runs a batch-B forward per half and
exchanges the predictions.  Both halves issue the same pair collectives in
the same order; their frame collectives run in disjoint groups.  The
approx caches do not compose with the pair (refused, as in JAX).

The approx caches (the JAX package's ``--approx``; output-changing, opt-in
through ``make_sampling_fns``'s ``uncond_interval``, ``guidance_interval``,
``uncond_extrap``, ``step_interval`` and ``step_extrap``) act on the steps
of ``sample``, which walks each phase in chunks of ``chunk_steps``: every
chunk starts from empty caches with all its flags 0 true, and the guided
and vanilla phases never share a chunk.  A full step runs the controlnet
pass on the CFG pair, then the unconditional forward fresh or its cached
prediction held / extrapolated in timestep space, then (guided) either the
fresh conditional forward + backward or a plain conditional forward with
the cached raw gradient; a skip step (the step cache) runs no model work:
its noise prediction is extrapolated from the last two full steps', and the
cached raw gradient is re-applied under the step's ramp.  The finer caches
count executed steps (:func:`_refresh_flags`).  Under a frame group the
caches hold each rank's frames, every rank takes the same branch, and a
step that computes no guidance returns a loss of 0.

``sample(..., resume_path=)`` writes the latents after every chunk and a
rerun continues from the last finished chunk, with the JAX package's keys
(``latents`` in f32, ``steps_done``, ``timesteps``, ``chunk_steps``,
``tag``), so a checkpoint means the same in either package.  Under a frame
group or a CFG pair each rank keeps its own latents under
``<resume_path>.rank<r>.npz`` (r the global rank), and the ranks continue
only from one step that every rank of the video holds.

The text conditioning of a pass is a :class:`Conditioning`: the
cross-attention context, and for SDXL's UNet (the ``text_time`` added
embedding) the pooled text and the size and crop ids.  Every function
takes either one or, for SD1.5, the context tensor alone (the conditioning
of that context, so the SD1.5 path runs the same kernels in the same
order); the CFG pair's concat and a batch's rows are its methods.  Frame
sharding and the CFG pair refuse the SDXL UNet; the approx caches carry its
conditioning as they carry a context.

Every function takes a leading batch axis of B examples (the sweep's
batches): the guidance loss sums a per-example mean, and
:class:`MotionClonePipeline` draws each example's noise from its own seed.
The lower-level functions take explicit noise and latents, so tests can
feed numpy inputs.  Entry points run on CUDA unless ``device="cpu"`` is
passed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

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
from motionclone_tpu_torch.models.layers import recomputed_segments
from motionclone_tpu_torch.models.sparse_controlnet import SparseControlNetModel
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
from motionclone_tpu_torch.parallel.frames import FrameGroup, exchange_pair
from motionclone_tpu_torch.utils import rng, trace

MotionRep = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
# (frame-scattered condition, its mask, conditioning scale: a float, or a
# (B, 1, 1, 1, 1) tensor of one scale per example)
CnCond = Tuple[torch.Tensor, torch.Tensor, Union[float, torch.Tensor]]
# one seed, or one per example of a batch
Seeds = Union[int, Sequence[int]]


@dataclasses.dataclass(frozen=True)
class Conditioning:
    """A batch's text conditioning: the cross-attention ``context`` (B, T,
    D), and for a UNet with the ``text_time`` embedding the ``pooled`` text
    (B, P) and the size and crop ``time_ids`` (B, 6), else None."""
    context: torch.Tensor
    pooled: Optional[torch.Tensor] = None
    time_ids: Optional[torch.Tensor] = None

    @classmethod
    def of(cls, emb) -> "Conditioning":
        """``emb`` itself, or the conditioning of a context tensor."""
        return emb if isinstance(emb, Conditioning) else cls(emb)

    def _map(self, fn) -> "Conditioning":
        return Conditioning(*(None if x is None else fn(x)
                              for x in (self.context, self.pooled, self.time_ids)))

    def cat(self, other: "Conditioning") -> "Conditioning":
        """This batch's rows, then ``other``'s (the CFG pair)."""
        pairs = zip((self.context, self.pooled, self.time_ids),
                    (other.context, other.pooled, other.time_ids))
        return Conditioning(*(None if a is None else torch.cat([a, b]) for a, b in pairs))

    def rows(self, sl: slice) -> "Conditioning":
        """The batch rows ``sl`` (an example's, or a half of the CFG pair)."""
        return self._map(lambda x: x[sl])

    def repeat(self, n: int) -> "Conditioning":
        """Each row ``n`` times in a row."""
        return self._map(lambda x: x.repeat_interleave(n, dim=0))

    def to(self, dtype: torch.dtype) -> "Conditioning":
        """The context and the pooled text in ``dtype`` (the ids stay f32)."""
        return Conditioning(self.context.to(dtype),
                            None if self.pooled is None else self.pooled.to(dtype),
                            self.time_ids)

    def unet_kwargs(self) -> dict:
        """The UNet's keyword argument beside the context."""
        return {} if self.pooled is None else {"added_cond": (self.pooled, self.time_ids)}


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


def _refresh_flags(n: int, k: int, executed=None) -> np.ndarray:
    """One chunk's refresh flags for a cache of interval ``k``: step 0 and
    every k-th step after it.  With ``executed`` (the step cache's mask of
    full steps) the count runs over executed steps only: a flag raised on a
    skipped step would be consumed without running, stretching the
    interval (uncond-cache:5 under step-extrap:2 would refresh every 10th
    step)."""
    if executed is None:
        return (np.arange(n) % k) == 0
    executed = np.asarray(executed, bool)
    return executed & (((np.cumsum(executed) - 1) % k) == 0)


def _const_col(n: int, w: float) -> np.ndarray:
    """A per-step column of the weight ``w`` in float32, as the JAX package
    feeds its extrapolation weights to the steps."""
    return np.full((n,), w, np.float32)


def _extrapolate(last: torch.Tensor, prev: torch.Tensor, t_last: float, t_prev: float,
                 n_ref: int, t: float, w: float) -> torch.Tensor:
    """A cached prediction at timestep ``t``: the last anchor plus ``w``
    times the slope through the last two anchors (in timestep space), in
    float32 and cast back to the anchors' dtype: bf16 anchor differences
    are the signal being amplified.  The slope counts only once two anchors
    exist (``n_ref >= 2``); w = 0 holds the cache."""
    denom = t_last - t_prev
    slope = (last.float() - prev.float()) / (1.0 if denom == 0 else denom)
    wk = float(np.float32(w) * np.float32(1.0 if n_ref >= 2 else 0.0))
    return (last.float() + wk * slope * float(np.float32(t) - np.float32(t_last))).to(last.dtype)


@dataclasses.dataclass
class _Anchors:
    """The last two refreshes of a cached prediction (zeros before them),
    their timesteps and how many there were."""
    last: torch.Tensor
    prev: torch.Tensor
    t_last: float = 0.0
    t_prev: float = 0.0
    n: int = 0

    @classmethod
    def empty(cls, like: torch.Tensor) -> "_Anchors":
        zeros = torch.zeros_like(like)
        return cls(zeros, zeros)

    def push(self, x: torch.Tensor, t: int) -> None:
        self.last, self.prev = x, self.last
        self.t_last, self.t_prev = float(t), self.t_last
        self.n += 1

    def extrapolate(self, t: int, w: float) -> torch.Tensor:
        return _extrapolate(self.last, self.prev, self.t_last, self.t_prev, self.n, t, w)


@dataclasses.dataclass
class _ApproxCarry:
    """What the approx steps carry within a chunk: the latents, the uncond
    prediction's anchors, the raw guidance gradient (unscaled by the ramp,
    in the latents' dtype) and the noise prediction's anchors (the step
    cache's)."""
    latents: torch.Tensor
    uncond: _Anchors
    grad: torch.Tensor
    noise: _Anchors

    @classmethod
    def start(cls, latents: torch.Tensor) -> "_ApproxCarry":
        return cls(latents, _Anchors.empty(latents), torch.zeros_like(latents),
                   _Anchors.empty(latents))


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per step of a run (guided steps first): whether it runs its model
    work (``full``; False: a skip step of the step cache, DDIM only), and
    on a full step whether the uncond forward and the guidance gradient
    are fresh (False: from the cache).  The exact path's steps are all
    True."""
    full: np.ndarray
    uncond: np.ndarray
    guidance: np.ndarray


@dataclasses.dataclass(frozen=True)
class SamplingFns:
    extract: Callable[..., MotionRep]
    guided_step: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    vanilla_step: Callable[..., torch.Tensor]
    sample: Callable[..., torch.Tensor]
    # schedule(chunk_steps=50, uncond_refresh=None, guidance_refresh=None,
    # step_refresh=None, plain=False) -> Schedule: the flags ``sample`` runs
    # with (``sample_plain``'s with ``plain``)
    schedule: Callable[..., Schedule]
    timesteps: np.ndarray
    # sample_plain(init_latents, uncond_emb, cond_emb, cn_cond=None,
    # chunk_steps=50, on_step=None) -> latents
    sample_plain: Callable[..., torch.Tensor]
    # sample_plain_probs(init_latents, uncond_emb, cond_emb, cn_cond=None,
    # chunk_steps=10) -> (latents, {module: float32 (steps, 2B, S, heads, F, F)})
    sample_plain_probs: Callable[..., Tuple[torch.Tensor, Dict[str, np.ndarray]]]
    plain_timesteps: np.ndarray
    frame_group: Optional[FrameGroup] = None  # None: unsharded
    cfg_pair: Optional[FrameGroup] = None  # None: both CFG halves on this rank


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
    uncond_interval: int = 1,
    guidance_interval: int = 1,
    uncond_extrap: float = 0.0,
    step_interval: int = 1,
    step_extrap: float = 0.0,
    cfg_pair: Optional[FrameGroup] = None,
) -> SamplingFns:
    """Build extract / guided_step / vanilla_step / sample / sample_plain /
    sample_plain_probs around ``unet``
    (its parameters' device and dtype set where the work runs), sharded
    over ``frame_group``'s ranks when it has more than one, the CFG pair
    split over ``cfg_pair``'s two ranks when given, conditioned by
    ``controlnet`` where a ``cn_cond`` is passed.

    The approx caches (output-changing; all off by default):
    ``uncond_interval`` > 1 refreshes the unconditional forward every K
    steps of both phases; ``guidance_interval`` > 1 the guidance gradient
    every K guided steps (a plain conditional forward in between);
    ``step_interval`` > 1 runs the full step every K steps (DDIM only in
    between); ``uncond_extrap`` and ``step_extrap`` in [0, 1] weight the
    linear extrapolation of the uncond and step caches (0 holds them).
    ``sample`` can override each at run time; ``sample_plain`` runs the
    build's uncond and step caches (the JAX package's too)."""
    if uncond_interval < 1:
        raise ValueError(f"uncond_interval must be >= 1, got {uncond_interval}")
    if guidance_interval < 1:
        raise ValueError(f"guidance_interval must be >= 1, got {guidance_interval}")
    if step_interval < 1:
        raise ValueError(f"step_interval must be >= 1, got {step_interval}")
    if uncond_extrap and uncond_interval == 1:
        raise ValueError(
            "uncond_extrap extrapolates the uncond cache: build "
            "make_sampling_fns(..., uncond_interval>1) to enable it")
    if step_extrap and step_interval == 1:
        raise ValueError(
            "step_extrap extrapolates the step cache: build "
            "make_sampling_fns(..., step_interval>1) to enable it")
    if hasattr(unet, "add_embedding") and (
            (frame_group is not None and frame_group.size > 1) or cfg_pair is not None):
        raise ValueError(
            "frame sharding and the CFG pair do not take a UNet with the text_time "
            "embedding (SDXL): run it on one device")
    group = check_frame_group(frame_group, unet.cfg, infer_cfg)
    pair = cfg_pair
    if pair is not None and pair.size != 2:
        raise ValueError(f"the cfg axis must have size 1 or 2 (the CFG pair), got {pair.size}")
    if pair is not None and (uncond_interval > 1 or guidance_interval > 1 or step_interval > 1):
        raise ValueError(
            "the cross-step caches (--approx) do not compose with CFG-pair "
            "splitting: the pair formulations evaluate both halves jointly")
    # the ranks that sample one video: their resume files and agreement
    video_groups = tuple(x for x in (group, pair) if x is not None)
    recompute = unet.cfg.guided_recompute
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
    # plain generation: the diffusers "leading" spacing over the whole range
    ts_plain = build_timesteps(infer_cfg.inference_steps, sched_cfg.num_train_timesteps,
                               steps_offset=sched_cfg.steps_offset, spacing="leading")
    tp_plain = prev_timesteps(ts_plain)

    def local_cn(cn_cond: Optional[CnCond]) -> Optional[CnCond]:
        """The rank's frames of a full condition and mask; under a frame
        group a controlnet needs them on every call."""
        if group is None or controlnet is None:
            return cn_cond
        if cn_cond is None:
            raise ValueError(
                "frame-sharded controlnet pipelines need cn_cond on every call; "
                "run unconditioned examples unsharded")
        cond, mask, scale = cn_cond
        if cond.shape[1] != infer_cfg.video_length:
            raise ValueError(f"a frame-sharded controlnet takes the full "
                             f"{infer_cfg.video_length} frames of the condition, got "
                             f"{cond.shape[1]}")
        return group.local_frames(cond), group.local_frames(mask), scale

    def residuals(latents, t: int, emb, cn_cond: Optional[CnCond]):
        """The controlnet's (down, mid) residuals for ``latents``, without
        grad; the condition (and a per-example scale) is tiled over a batch
        twice its own (the CFG pair).  None without a controlnet or a
        condition."""
        if controlnet is None or cn_cond is None:
            return None
        cond, mask, scale = cn_cond
        if latents.shape[0] == 2 * cond.shape[0]:
            cond, mask = torch.cat([cond, cond]), torch.cat([mask, mask])
            if torch.is_tensor(scale):
                scale = torch.cat([scale, scale])
        with trace.span("controlnet"), torch.no_grad():
            return controlnet(latents, t, emb.context, cond, mask, scale, impl=plain_impl,
                              frame_group=group)

    def residual_kwargs(res, sl: slice = slice(None)):
        # the UNet's keyword arguments for the residuals' batch rows ``sl``
        if res is None:
            return {}
        down, mid = res
        return dict(down_block_residuals=tuple(d[sl] for d in down),
                    mid_block_residual=mid[sl])

    def extract(video_latents, noise, uncond_emb, cn_cond: Optional[CnCond] = None
                ) -> MotionRep:
        uncond_emb = Conditioning.of(uncond_emb)
        cn_cond = local_cn(cn_cond)
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
            _, probs = unet(noisy, infer_cfg.add_noise_step, uncond_emb.context,
                            guidance_blocks=guidance, max_up_block=cut,
                            frame_group=group, **residual_kwargs(res),
                            **uncond_emb.unet_kwargs())
        return {k: sparsify_top1(p) for k, p in probs.items()}

    def pair_residuals(latents, t: int, uncond_emb, cond_emb, cn_cond):
        # one batch-2 controlnet pass on the CFG pair
        return residuals(torch.cat([latents, latents]), t, uncond_emb.cat(cond_emb), cn_cond)

    def plain_pass(latents, t: int, emb, res, sl: slice = slice(None)):
        """A forward without grad on the path of the passes that are not
        differentiated, with the residuals' rows ``sl``."""
        with trace.span("unet_plain"), torch.no_grad():
            pred, _ = unet(latents, t, emb.context, attention_impl=plain_impl,
                           frame_group=group, **residual_kwargs(res, sl),
                           **emb.unet_kwargs())
        return pred

    def pair_pass(latents, t: int, uncond_emb, cond_emb, res):
        # the batch-2 CFG forward -> (uncond, cond) predictions
        b = latents.shape[0]
        pred2 = plain_pass(torch.cat([latents, latents]), t, uncond_emb.cat(cond_emb), res)
        return pred2[:b], pred2[b:]

    def guidance_pass(latents, t: int, cond_emb, motion_rep: MotionRep, res, sl: slice):
        """The conditional forward under autograd and the gradient of the
        guidance loss with respect to the latents -> (cond prediction, raw
        gradient, the loss summed over the ranks)."""
        with torch.enable_grad():
            with trace.span("unet_guided_fwd"):
                leaf = latents.detach().requires_grad_(True)
                cond_pred, probs = unet(leaf, t, cond_emb.context, guidance_blocks=guidance,
                                        post_guidance_cut=cut,
                                        post_guidance_impl=plain_impl, frame_group=group,
                                        **residual_kwargs(res, sl), **cond_emb.unet_kwargs())
                loss = infer_cfg.motion_guidance_weight * motion_guidance_loss(
                    probs, motion_rep, group
                )
            before = recomputed_segments()
            # the recomputed segments' re-runs (on autograd's device thread
            # on a card) are spans of this one
            with trace.span("unet_guided_bwd", backward=True):
                (grad,) = torch.autograd.grad(loss, leaf)
            if recompute:
                trace.annotate("step", recomputed=recomputed_segments() - before)
        loss = loss.detach()
        if group is not None:  # the value: the ranks' partials summed
            loss = group.all_reduce_sum(loss)
        return cond_pred.detach(), grad, loss

    def combine(cond_pred, uncond_pred):
        # the reference's CFG base: cond + s * (cond - uncond)
        return cond_pred + cfg_scale * (cond_pred - uncond_pred)

    def guided_serial(latents, t: int, tp: int, ramp: float, uncond_emb, cond_emb,
                      motion_rep: MotionRep, cn_cond: Optional[CnCond]):
        b = latents.shape[0]
        res = pair_residuals(latents, t, uncond_emb, cond_emb, cn_cond)
        uncond_pred = plain_pass(latents, t, uncond_emb, res, slice(None, b))
        cond_pred, grad, loss = guidance_pass(latents, t, cond_emb, motion_rep, res,
                                              slice(b, None))
        # the loss ramp scales the score linearly
        new = ddim_step(ddim, combine(cond_pred, uncond_pred), t, tp, latents,
                        score=grad * ramp, guidance_scale=1.0)
        return new, loss

    def vanilla_serial(latents, t: int, tp: int, uncond_emb, cond_emb,
                       cn_cond: Optional[CnCond]):
        res = pair_residuals(latents, t, uncond_emb, cond_emb, cn_cond)
        uncond_pred, cond_pred = pair_pass(latents, t, uncond_emb, cond_emb, res)
        return ddim_step(ddim, combine(cond_pred, uncond_pred), t, tp, latents)

    def half_emb(uncond_emb, cond_emb):
        # this rank's CFG half: pair rank 0 is the unconditional one
        return cond_emb if pair.rank == 1 else uncond_emb

    def guided_pair(latents, t: int, tp: int, ramp: float, uncond_emb, cond_emb,
                    motion_rep: MotionRep, cn_cond: Optional[CnCond]):
        emb = half_emb(uncond_emb, cond_emb)
        res = residuals(latents, t, emb, cn_cond)
        if pair.rank == 1:
            pred, grad, loss = guidance_pass(latents, t, emb, motion_rep, res, slice(None))
        else:
            pred = plain_pass(latents, t, emb, res)
            grad = torch.zeros_like(latents)
            loss = torch.zeros((), dtype=torch.float32, device=latents.device)
        (uncond_pred, _, _), (cond_pred, grad, loss) = exchange_pair(pair, [pred, grad, loss])
        new = ddim_step(ddim, combine(cond_pred, uncond_pred), t, tp, latents,
                        score=grad * ramp, guidance_scale=1.0)
        return new, loss

    def vanilla_pair(latents, t: int, tp: int, uncond_emb, cond_emb,
                     cn_cond: Optional[CnCond]):
        emb = half_emb(uncond_emb, cond_emb)
        pred = plain_pass(latents, t, emb, residuals(latents, t, emb, cn_cond))
        (uncond_pred,), (cond_pred,) = exchange_pair(pair, [pred])
        return ddim_step(ddim, combine(cond_pred, uncond_pred), t, tp, latents)

    exact_guided = guided_serial if pair is None else guided_pair
    exact_vanilla = vanilla_serial if pair is None else vanilla_pair

    def guided_step(latents, t: int, tp: int, ramp: float, uncond_emb, cond_emb,
                    motion_rep: MotionRep, cn_cond: Optional[CnCond] = None):
        """Returns (new latents, guidance loss)."""
        return exact_guided(latents, t, tp, ramp, Conditioning.of(uncond_emb),
                            Conditioning.of(cond_emb), motion_rep, local_cn(cn_cond))

    def vanilla_step(latents, t: int, tp: int, uncond_emb, cond_emb,
                     cn_cond: Optional[CnCond] = None):
        return exact_vanilla(latents, t, tp, Conditioning.of(uncond_emb),
                             Conditioning.of(cond_emb), local_cn(cn_cond))

    def guided_step_approx(carry: _ApproxCarry, t: int, tp: int, ramp: float, flags,
                           uncond_emb, cond_emb, motion_rep: MotionRep, cn_cond):
        """A guided step of ``sample``, through the caches: ``flags`` =
        (full, fresh uncond, fresh guidance, uncond weight, step weight);
        updates ``carry`` and returns the loss (0 where no gradient was
        taken).  With every flag true (the exact schedule) this is
        :func:`guided_step`'s arithmetic."""
        full, fresh_u, fresh_g, w_u, w_s = flags
        latents = carry.latents
        b = latents.shape[0]
        loss = torch.zeros((), dtype=torch.float32, device=latents.device)
        if full:
            res = pair_residuals(latents, t, uncond_emb, cond_emb, cn_cond)
            if fresh_u:
                uncond_pred = plain_pass(latents, t, uncond_emb, res, slice(None, b))
                carry.uncond.push(uncond_pred, t)
            else:
                uncond_pred = carry.uncond.extrapolate(t, w_u)
            if fresh_g:
                cond_pred, carry.grad, loss = guidance_pass(latents, t, cond_emb,
                                                            motion_rep, res, slice(b, None))
            else:  # the full UNet, without grad; the gradient from the cache
                cond_pred = plain_pass(latents, t, cond_emb, res, slice(b, None))
            noise_pred = combine(cond_pred, uncond_pred)
            carry.noise.push(noise_pred, t)
        else:
            noise_pred = carry.noise.extrapolate(t, w_s)
        carry.latents = ddim_step(ddim, noise_pred, t, tp, latents, score=carry.grad * ramp,
                                  guidance_scale=1.0)
        return loss

    def vanilla_step_approx(carry: _ApproxCarry, t: int, tp: int, flags, uncond_emb,
                            cond_emb, cn_cond):
        """A vanilla step of ``sample``, through the caches (``flags`` as
        :func:`guided_step_approx`'s; the guidance flag is unused): the
        batch-2 pair on a fresh-uncond step (every step of the exact
        schedule, :func:`vanilla_step`'s arithmetic), else a batch-1
        conditional forward beside the cached uncond prediction."""
        full, fresh_u, _, w_u, w_s = flags
        latents = carry.latents
        b = latents.shape[0]
        if full:
            res = pair_residuals(latents, t, uncond_emb, cond_emb, cn_cond)
            if fresh_u:
                uncond_pred, cond_pred = pair_pass(latents, t, uncond_emb, cond_emb, res)
                carry.uncond.push(uncond_pred, t)
            else:
                cond_pred = plain_pass(latents, t, cond_emb, res, slice(b, None))
                uncond_pred = carry.uncond.extrapolate(t, w_u)
            noise_pred = combine(cond_pred, uncond_pred)
            carry.noise.push(noise_pred, t)
        else:
            noise_pred = carry.noise.extrapolate(t, w_s)
        carry.latents = ddim_step(ddim, noise_pred, t, tp, latents)

    def vanilla_chunk_step(carry: _ApproxCarry, t: int, tp: int, flags, uncond_emb,
                           cond_emb, cn_cond):
        """A vanilla step of a chunk: the pair step under a CFG pair (exact
        only: every flag is true), else the cached step."""
        if pair is not None:
            carry.latents = vanilla_pair(carry.latents, t, tp, uncond_emb, cond_emb, cn_cond)
        else:
            vanilla_step_approx(carry, t, tp, flags, uncond_emb, cond_emb, cn_cond)

    def chunks(chunk_steps: int, n_guided: int = g,
               total: int = len(timesteps)) -> Iterator[Tuple[int, int]]:
        """[lo, hi) of each chunk: the ``n_guided`` guided steps, then the
        vanilla ones up to ``total`` (``sample``'s schedule by default;
        plain generation has no guided step)."""
        if chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        for begin, end in ((0, n_guided), (n_guided, total)):
            for lo in range(begin, end, chunk_steps):
                yield lo, min(lo + chunk_steps, end)

    def intervals(uncond_refresh, guidance_refresh, uncond_extrap_w, step_refresh,
                  step_extrap_w):
        """The run's (K_u, K_g, w_u, K_s, w_s): the build's, or the
        overrides, which need the cache they override."""
        for name, value, built, what in (
                ("uncond_refresh", uncond_refresh, uncond_interval, "uncond_interval"),
                ("guidance_refresh", guidance_refresh, guidance_interval, "guidance_interval"),
                ("step_refresh", step_refresh, step_interval, "step_interval")):
            if value is not None and built == 1:
                raise ValueError(f"{name} needs the approx executables: build "
                                 f"make_sampling_fns(..., {what}>1)")
        k_u = uncond_interval if uncond_refresh is None else uncond_refresh
        k_g = guidance_interval if guidance_refresh is None else guidance_refresh
        k_s = step_interval if step_refresh is None else step_refresh
        for name, value in (("uncond_refresh", k_u), ("guidance_refresh", k_g),
                            ("step_refresh", k_s)):
            if value < 1:
                raise ValueError(f"{name} must be >= 1, got {value}")
        for name, value, built, what in (
                ("uncond_extrap_w", uncond_extrap_w, uncond_interval, "uncond_interval"),
                ("step_extrap_w", step_extrap_w, step_interval, "step_interval")):
            if value is not None and built == 1:
                raise ValueError(f"{name} needs the approx executables: build "
                                 f"make_sampling_fns(..., {what}>1)")
        w_u = uncond_extrap if uncond_extrap_w is None else uncond_extrap_w
        w_s = step_extrap if step_extrap_w is None else step_extrap_w
        return k_u, k_g, w_u, k_s, w_s

    def flags_of(chunk_steps: int, k_u: int, k_g: int, k_s: int, n_guided: int = g,
                 total: int = len(timesteps)) -> Schedule:
        """The chunk-relative flags of a schedule of ``n_guided`` guided
        steps of ``total`` (see :func:`chunks`)."""
        full, fresh_u, fresh_g = [], [], []
        for lo, hi in chunks(chunk_steps, n_guided, total):
            size = hi - lo
            # the finer caches count executed (full) steps
            executed = _refresh_flags(size, k_s)
            full.append(executed)
            fresh_u.append(_refresh_flags(size, k_u, executed))
            fresh_g.append(_refresh_flags(size, k_g, executed) if lo < n_guided
                           else np.ones(size, bool))
        return Schedule(*(np.concatenate(f) for f in (full, fresh_u, fresh_g)))

    def schedule(chunk_steps: int = 50, uncond_refresh: Optional[int] = None,
                 guidance_refresh: Optional[int] = None,
                 step_refresh: Optional[int] = None, plain: bool = False) -> Schedule:
        k_u, k_g, _, k_s, _ = intervals(uncond_refresh, guidance_refresh, None,
                                        step_refresh, None)
        if plain:
            return flags_of(chunk_steps, k_u, k_g, k_s, 0, len(ts_plain))
        return flags_of(chunk_steps, k_u, k_g, k_s)

    def sample(init_latents, uncond_emb, cond_emb, motion_rep: MotionRep,
               on_step: Optional[Callable[[int, bool], None]] = None,
               cn_cond: Optional[CnCond] = None, chunk_steps: int = 50,
               resume_path: Optional[str] = None,
               on_chunk: Optional[Callable[[int, int], None]] = None,
               resume_tag: str = "", uncond_refresh: Optional[int] = None,
               guidance_refresh: Optional[int] = None,
               uncond_extrap_w: Optional[float] = None,
               step_refresh: Optional[int] = None,
               step_extrap_w: Optional[float] = None):
        """Guided then vanilla phase, each in chunks of ``chunk_steps``;
        ``on_step(index, guided)`` is called after each step,
        ``on_chunk(steps_done, total)`` after each chunk.  The
        ``*_refresh`` / ``*_extrap_w`` arguments override the build's
        intervals and weights.  With ``resume_path`` the latents are
        written after each chunk, a run finds them there and continues
        (a checkpoint of another ``chunk_steps``, ``resume_tag``, schedule
        or shape is ignored), and the file is deleted at the end.  Under a
        frame group each rank keeps its own frames in
        ``<resume_path>.rank<r>.npz``, and the group continues from them
        only where every rank's file holds the same step; else every rank
        starts again from ``init_latents``; under a CFG pair too, over the
        video's ranks.  The exact schedule runs through the same steps as
        the caches, with every flag true (under a CFG pair, the pair
        steps)."""
        uncond_emb, cond_emb = Conditioning.of(uncond_emb), Conditioning.of(cond_emb)
        with trace.span("sample", device=init_latents.device):
            cn_cond = local_cn(cn_cond)
            k_u, k_g, w_u, k_s, w_s = intervals(uncond_refresh, guidance_refresh,
                                                uncond_extrap_w, step_refresh, step_extrap_w)
            flags = flags_of(chunk_steps, k_u, k_g, k_s)
            w_u, w_s = (_const_col(len(timesteps), w) for w in (w_u, w_s))
            fingerprint = np.asarray(timesteps, np.int32)
            total = len(timesteps)
            if resume_path and video_groups:
                rank = dist.get_rank() if dist.is_initialized() else video_groups[0].rank
                resume_path = f"{resume_path}.rank{rank}.npz"
            latents, steps_done = init_latents, 0  # init_noise_sigma == 1 for DDIM
            if resume_path and os.path.exists(resume_path):
                with np.load(resume_path) as d:
                    if (int(d["chunk_steps"]) == chunk_steps and str(d["tag"]) == resume_tag
                            and d["timesteps"].shape == fingerprint.shape
                            and (d["timesteps"] == fingerprint).all()
                            and tuple(d["latents"].shape) == tuple(init_latents.shape)):
                        steps_done = int(d["steps_done"])
                        latents = torch.from_numpy(d["latents"]).to(device=init_latents.device,
                                                                    dtype=init_latents.dtype)
            if resume_path and video_groups:
                # a run killed between two ranks' writes leaves their files a
                # chunk apart; each rank keeps only its last checkpoint, so the
                # video continues only where every rank stopped at one step
                done = torch.tensor([steps_done], dtype=torch.int64, device=init_latents.device)
                for ranks in video_groups:  # over the frames, then the pair: every rank's
                    done = ranks.gather_frames(done, dim=0)
                if (done != steps_done).any():
                    latents, steps_done = init_latents, 0
            for lo, hi in chunks(chunk_steps):
                if hi <= steps_done:  # checkpointed
                    continue
                guided = lo < g
                carry = _ApproxCarry.start(latents)  # every chunk starts from empty caches
                for i in range(lo, hi):
                    with trace.span("step", index=i, guided=guided, full=bool(flags.full[i])):
                        t, tp = int(timesteps[i]), int(t_prev[i])
                        step_flags = (flags.full[i], flags.uncond[i], flags.guidance[i],
                                      float(w_u[i]), float(w_s[i]))
                        if not guided:
                            vanilla_chunk_step(carry, t, tp, step_flags, uncond_emb, cond_emb,
                                               cn_cond)
                        elif pair is not None:  # exact only: every flag is true
                            carry.latents = guided_pair(carry.latents, t, tp, float(ramps[i]),
                                                        uncond_emb, cond_emb, motion_rep,
                                                        cn_cond)[0]
                        else:
                            guided_step_approx(carry, t, tp, float(ramps[i]), step_flags,
                                               uncond_emb, cond_emb, motion_rep, cn_cond)
                    if on_step is not None:
                        on_step(i, guided)
                latents = carry.latents
                if resume_path:
                    # f32 on disk (npz has no bf16), cast back exactly; keep the
                    # .npz suffix, which np.savez would append otherwise
                    tmp = resume_path + ".tmp.npz"
                    np.savez(tmp, latents=latents.float().cpu().numpy(), steps_done=hi,
                             timesteps=fingerprint, chunk_steps=chunk_steps, tag=resume_tag)
                    os.replace(tmp, resume_path)
                if on_chunk is not None:
                    on_chunk(hi, total)
            if resume_path and os.path.exists(resume_path):
                os.remove(resume_path)
            return latents

    def sample_plain(init_latents, uncond_emb, cond_emb, cn_cond: Optional[CnCond] = None,
                     chunk_steps: int = 50,
                     on_step: Optional[Callable[[int, bool], None]] = None):
        """Plain generation on the "leading" schedule, every step a vanilla
        step, in chunks of ``chunk_steps`` through the cached steps with the
        build's uncond and step caches (``schedule(chunk_steps,
        plain=True)``'s flags; every flag true without them);
        ``on_step(index, False)`` is called after each step."""
        uncond_emb, cond_emb = Conditioning.of(uncond_emb), Conditioning.of(cond_emb)
        cn_cond = local_cn(cn_cond)
        flags = schedule(chunk_steps, plain=True)
        w_u, w_s = (float(np.float32(w)) for w in (uncond_extrap, step_extrap))
        latents = init_latents  # init_noise_sigma == 1 for DDIM
        with trace.span("sample", device=init_latents.device):
            for lo, hi in chunks(chunk_steps, 0, len(ts_plain)):
                carry = _ApproxCarry.start(latents)  # every chunk starts from empty caches
                for i in range(lo, hi):
                    with trace.span("step", index=i, guided=False, full=bool(flags.full[i])):
                        vanilla_chunk_step(carry, int(ts_plain[i]), int(tp_plain[i]),
                                           (flags.full[i], flags.uncond[i], True, w_u, w_s),
                                           uncond_emb, cond_emb, cn_cond)
                    if on_step is not None:
                        on_step(i, False)
                latents = carry.latents
        return latents

    def probs_step(latents, t: int, tp: int, uncond_emb, cond_emb, cn_cond):
        """A vanilla step whose CFG forward (no cut) also returns the
        guidance blocks' temporal-attention probabilities -> (new latents,
        {module: (2B, S, heads, f, F)}, the unconditional rows first).  The
        modules that return them take the plain probability route.  Under
        a CFG pair each half runs its own forward and the pair exchanges
        the predictions and the maps."""
        b = latents.shape[0]
        if pair is None:
            res = pair_residuals(latents, t, uncond_emb, cond_emb, cn_cond)
            lat, emb = torch.cat([latents, latents]), uncond_emb.cat(cond_emb)
        else:
            emb = half_emb(uncond_emb, cond_emb)
            lat, res = latents, residuals(latents, t, emb, cn_cond)
        with torch.no_grad():
            pred, probs = unet(lat, t, emb.context, guidance_blocks=guidance,
                               attention_impl=plain_impl, frame_group=group,
                               **residual_kwargs(res), **emb.unet_kwargs())
        if pair is None:
            uncond_pred, cond_pred = pred[:b], pred[b:]
        else:
            keys = sorted(probs)
            uncond, cond = exchange_pair(pair, [pred] + [probs[k] for k in keys])
            uncond_pred, cond_pred = uncond[0], cond[0]
            probs = {k: torch.cat([u, c]) for k, u, c in zip(keys, uncond[1:], cond[1:])}
        return ddim_step(ddim, combine(cond_pred, uncond_pred), t, tp, latents), probs

    def sample_plain_probs(init_latents, uncond_emb, cond_emb,
                           cn_cond: Optional[CnCond] = None, chunk_steps: int = 10):
        """:func:`sample_plain`'s exact schedule through :func:`probs_step`
        -> (latents, {module: float32 numpy (steps, 2B, S, heads, F, F)}).
        Each chunk's maps go to the host before the next chunk runs; under
        a frame group their query frames are gathered, so that every rank
        holds the whole video's."""
        uncond_emb, cond_emb = Conditioning.of(uncond_emb), Conditioning.of(cond_emb)
        cn_cond = local_cn(cn_cond)
        latents, collected = init_latents, []
        for lo, hi in chunks(chunk_steps, 0, len(ts_plain)):
            steps = []
            for i in range(lo, hi):
                latents, probs = probs_step(latents, int(ts_plain[i]), int(tp_plain[i]),
                                            uncond_emb, cond_emb, cn_cond)
                steps.append(probs)
            chunk = {k: torch.stack([p[k] for p in steps]) for k in steps[0]}
            if group is not None:  # (steps, 2B, S, heads, f, F): query frames on axis 4
                chunk = {k: group.gather_frames(v, 4) for k, v in chunk.items()}
            collected.append({k: v.float().cpu().numpy() for k, v in chunk.items()})
        return latents, {k: np.concatenate([c[k] for c in collected])
                         for k in (collected[0] if collected else {})}

    return SamplingFns(extract=extract, guided_step=guided_step,
                       vanilla_step=vanilla_step, sample=sample,
                       timesteps=timesteps, frame_group=group, schedule=schedule,
                       cfg_pair=pair, sample_plain=sample_plain,
                       sample_plain_probs=sample_plain_probs, plain_timesteps=ts_plain)


class MotionClonePipeline:
    """Host-side orchestration: seeds, text and VAE integration.

    ``unet`` (and the optional ``vae`` / ``text_encoder`` /
    ``text_encoder_2``) are moved to ``device`` and ``dtype``; the default
    is CUDA in bfloat16, and so is the optional ``controlnet``.  With a
    second text tower (SDXL) the text is a :class:`Conditioning`: both
    towers' states joined on the last axis, the second's pooled text, and
    the size and crop ids of the video's size.  ``attention_impl``, ``frame_group``,
    ``cfg_pair``, ``controlnet`` and the approx knobs (``uncond_interval``,
    ``guidance_interval``, ``uncond_extrap``, ``step_interval``,
    ``step_extrap``) are those of :func:`make_sampling_fns`; a ``cn_cond`` is
    moved to the device and dtype before it conditions a pass.  Every noise tensor is drawn by
    ``utils.rng.draw_normal`` in its own domain of the seed (the VAE
    posterior, the extraction noise, the initial latents), so one seed gives
    three independent draws.  A batch of B examples passes B seeds: each
    example's noise is the draw of its own seed at batch 1, stacked, as the
    JAX package's sweep draws it.  Under a frame group every rank draws the
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
        text_encoder_2=None,
        device="cuda",
        dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "auto",
        frame_group: Optional[FrameGroup] = None,
        controlnet: Optional[SparseControlNetModel] = None,
        uncond_interval: int = 1,
        guidance_interval: int = 1,
        uncond_extrap: float = 0.0,
        step_interval: int = 1,
        step_extrap: float = 0.0,
        cfg_pair: Optional[FrameGroup] = None,
    ):
        infer_cfg.validate()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.unet_cfg, self.sched_cfg, self.infer_cfg = unet_cfg, sched_cfg, infer_cfg
        self.unet = unet.to(device=self.device, dtype=dtype).eval()
        self.vae = None if vae is None else vae.to(device=self.device, dtype=dtype).eval()
        self.text_encoder, self.text_encoder_2 = (
            None if m is None else m.to(device=self.device, dtype=dtype).eval()
            for m in (text_encoder, text_encoder_2))
        self.controlnet = (
            None if controlnet is None
            else controlnet.to(device=self.device, dtype=dtype).eval()
        )
        self.fns = make_sampling_fns(
            self.unet, sched_cfg, infer_cfg, attention_impl, frame_group, self.controlnet,
            uncond_interval=uncond_interval, guidance_interval=guidance_interval,
            uncond_extrap=uncond_extrap, step_interval=step_interval,
            step_extrap=step_extrap, cfg_pair=cfg_pair)

    @torch.no_grad()
    def encode_text(self, input_ids):
        """Token ids (B, 77) -> text embeddings (B, 77, hidden); with a
        second tower, each tower's ids (a pair) -> its :class:`Conditioning`
        (:meth:`time_ids` of the video's size)."""
        if self.text_encoder_2 is None:
            return self.text_encoder(input_ids.to(self.device))
        ids_1, ids_2 = (x.to(self.device) for x in input_ids)
        state_1 = self.text_encoder(ids_1)
        state_2, pooled = self.text_encoder_2.encode(ids_2)
        return Conditioning(torch.cat([state_1, state_2], dim=-1), pooled,
                            self.time_ids(ids_1.shape[0]))

    def time_ids(self, batch: int) -> torch.Tensor:
        """SDXL's size and crop ids (batch, 6) f32 of the video's size: the
        original height and width, a crop at (0, 0), the target height and
        width."""
        h, w = self.infer_cfg.height, self.infer_cfg.width
        return torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32,
                            device=self.device).repeat(batch, 1)

    def _draw(self, shape, seed: Seeds, domain: int) -> torch.Tensor:
        """``shape``'s noise in ``domain``: of ``seed``, or with one seed
        per example, each example's draw at batch 1, stacked."""
        if isinstance(seed, (int, np.integer)):
            return rng.draw_normal(shape, seed, domain, self.device)
        if len(seed) != shape[0]:
            raise ValueError(f"{len(seed)} seeds for a batch of {shape[0]}")
        return torch.cat([rng.draw_normal((1,) + tuple(shape[1:]), s, domain, self.device)
                          for s in seed])

    @torch.no_grad()
    def encode_video(self, video: torch.Tensor, seed: Seeds,
                     domain: int = rng.VAE_POSTERIOR) -> torch.Tensor:
        """Pixels (F, H, W, 3) in [-1, 1] -> scaled latents (1, F, h, w, 4)
        with a posterior draw in ``domain`` of ``seed`` (the reference
        video's by default; the i2v condition images' is
        ``rng.CN_IMAGE_POSTERIOR``); a batch (B, F, H, W, 3) takes one seed
        per example."""
        from motionclone_tpu_torch.models.vae import sample_latents

        x = video.to(device=self.device, dtype=self.dtype)
        if x.dim() == 4:
            x = x[None]
        mean, logvar = self.vae.encode(x)
        eps = self._draw(mean.shape, seed, domain)
        z = sample_latents(mean, logvar, eps)
        return z * self.vae.cfg.scaling_factor

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents (1, F, h, w, 4) -> pixels (F, H, W, 3) in [-1, 1] (one
        example: a batch decodes each example's slice)."""
        z = latents.to(self.dtype) / self.vae.cfg.scaling_factor
        return self.vae.decode(z)[0]

    def gather_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """The full video's latents from each rank's frames (the latents
        themselves when unsharded)."""
        group = self.fns.frame_group
        return latents if group is None else group.gather_frames(latents)

    def local_motion_rep(self, rep: MotionRep) -> MotionRep:
        """A whole video's motion representation -> the rank's query
        frames (axis 3; the representation itself when unsharded)."""
        group = self.fns.frame_group
        if group is None:
            return rep
        return {k: (group.local_frames(v, 3), group.local_frames(i, 3))
                for k, (v, i) in rep.items()}

    def gather_motion_rep(self, rep: MotionRep) -> MotionRep:
        """The whole video's motion representation from each rank's query
        frames (the representation itself when unsharded)."""
        group = self.fns.frame_group
        if group is None:
            return rep
        return {k: (group.gather_frames(v, 3), group.gather_frames(i, 3))
                for k, (v, i) in rep.items()}

    def _cn_cond(self, cn_cond: Optional[CnCond]) -> Optional[CnCond]:
        if cn_cond is None:
            return None
        cond, mask, scale = cn_cond
        mv = lambda x: x.to(device=self.device, dtype=self.dtype)
        return mv(cond), mv(mask), mv(scale) if torch.is_tensor(scale) else float(scale)

    def extract_motion_representation(
        self, video_latents: torch.Tensor, uncond_emb: torch.Tensor, seed: Seeds,
        cn_cond: Optional[CnCond] = None,
    ) -> MotionRep:
        """One truncated forward on the full video's latents -> the sparse
        motion representation (the rank's query frames when sharded); a
        batch takes one seed per example."""
        noise = self._draw(video_latents.shape, seed, rng.EXTRACT_NOISE)
        return self.fns.extract(video_latents.to(self.dtype), noise.to(self.dtype),
                                uncond_emb.to(self.dtype), self._cn_cond(cn_cond))

    def initial_latents(self, seed: Seeds) -> torch.Tensor:
        """The initial latents drawn from ``seed``: the whole video's noise
        (1, F, h, w, 4), or the rank's frames of it when sharded; with one
        seed per example, (B, F, h, w, 4)."""
        cfg = self.infer_cfg
        b = 1 if isinstance(seed, (int, np.integer)) else len(seed)
        shape = (b, cfg.video_length, cfg.height // 8, cfg.width // 8,
                 self.unet_cfg.in_channels)
        latents = self._draw(shape, seed, rng.INIT_LATENTS).to(self.dtype)
        if self.fns.frame_group is not None:
            latents = self.fns.frame_group.local_frames(latents)
        return latents

    def sample_latents(
        self, uncond_emb: torch.Tensor, cond_emb: torch.Tensor,
        motion_rep: MotionRep, seed: Seeds,
        on_step: Optional[Callable[[int, bool], None]] = None,
        cn_cond: Optional[CnCond] = None,
        resume_path: Optional[str] = None,
        on_chunk: Optional[Callable[[int, int], None]] = None,
        chunk_steps: int = 50,
        resume_tag: str = "",
    ) -> torch.Tensor:
        """Guided DDIM sampling from seeded noise (one seed per example of
        a batch) -> final latents (the rank's frames when sharded);
        ``resume_path``, ``resume_tag``, ``on_chunk`` and ``chunk_steps``
        are those of the sampling functions' ``sample``."""
        latents = self.initial_latents(seed)
        return self.fns.sample(latents, uncond_emb.to(self.dtype),
                               cond_emb.to(self.dtype), motion_rep, on_step=on_step,
                               cn_cond=self._cn_cond(cn_cond), chunk_steps=chunk_steps,
                               resume_path=resume_path, on_chunk=on_chunk,
                               resume_tag=resume_tag)

    def sample_latents_plain(
        self, uncond_emb: torch.Tensor, cond_emb: torch.Tensor, seed: Seeds,
        cn_cond: Optional[CnCond] = None, save_probs_path: Optional[str] = None,
        on_step: Optional[Callable[[int, bool], None]] = None,
    ) -> torch.Tensor:
        """Plain generation without motion guidance from the same seeded
        noise as :meth:`sample_latents` -> final latents (the rank's frames
        when sharded).  ``save_probs_path``: the reference's ``save_probs``
        dump, through ``sample_plain_probs``: every step's
        temporal-attention probabilities of the guidance blocks written by
        ``np.savez`` (a key per module, the step index leading), by the
        video's lead rank alone where it has several; ``on_step`` is
        ``sample_plain``'s."""
        latents = self.initial_latents(seed)
        uncond_emb, cond_emb = uncond_emb.to(self.dtype), cond_emb.to(self.dtype)
        cn_cond = self._cn_cond(cn_cond)
        if save_probs_path is None:
            return self.fns.sample_plain(latents, uncond_emb, cond_emb, cn_cond,
                                         on_step=on_step)
        latents, probs = self.fns.sample_plain_probs(latents, uncond_emb, cond_emb, cn_cond)
        if all(g.rank == 0 for g in (self.fns.frame_group, self.fns.cfg_pair)
               if g is not None):
            np.savez(save_probs_path, **probs)
        return latents
