"""Rank bodies of tests/test_torch_frame_shard.py.

Each runs in a process of its own that ``parallel.frames.launch`` spawns,
as one rank of a gloo group on the CPU.  This module imports no JAX, so that
the ranks start fast, and it holds no tests."""

import os
import shutil

import numpy as np
import torch

from motionclone_tpu_torch.diffusion.guidance import motion_guidance_loss
from motionclone_tpu_torch.models.motion_module import VanillaTemporalModule
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline, make_sampling_fns


def frame_shard_rank(group, module_case, pipeline_case):
    """Both cases on this rank; returns {"module": ..., "pipeline": ...}."""
    torch.set_num_threads(1)  # several ranks share the test worker's cores
    return {"module": sharded_module(group, **module_case),
            "pipeline": sharded_pipeline(group, **pipeline_case)}


def sharded_module(group, state_dict, cfg, x, w):
    """A VanillaTemporalModule on the rank's frames of ``x``: its output and
    the gradient of the rank's partial objective sum(w * out) with respect
    to its input, each gathered over the ranks."""
    m = VanillaTemporalModule(x.shape[-1], cfg)
    m.load_state_dict(state_dict, strict=True)
    xl = group.local_frames(x).clone().requires_grad_(True)
    out, _ = m.eval()(xl, frame_group=group)
    (grad,) = torch.autograd.grad((group.local_frames(w) * out).sum(), xl)
    return {"out": group.gather_frames(out.detach()), "grad": group.gather_frames(grad)}


def sharded_pipeline(group, state_dict, unet_cfg, sched_cfg, infer_cfg,
                     video_latents, noise, init, uncond, cond, draw_seed):
    """Extraction from the full latents and noise, ``sample`` from the
    rank's frames of ``init``, and the first guided step's loss: the rank's
    partial and the sum that ``guided_step`` returns.  The representation
    and the latents come back gathered over the ranks.  Also the rank's
    own initial latents for ``draw_seed`` (``initial_latents``, drawn after
    seeding torch's global generator with the rank, which the draw must
    not depend on)."""
    unet = UNet3DConditionModel(unet_cfg)
    unet.load_state_dict(state_dict, strict=True)
    unet.eval()
    fns = make_sampling_fns(unet, sched_cfg, infer_cfg, frame_group=group)
    rep = fns.extract(video_latents, noise, uncond)
    latents = fns.sample(group.local_frames(init), uncond, cond, rep)
    t, tp = (int(x) for x in fns.timesteps[:2])
    local = group.local_frames(init)
    with torch.no_grad():
        _, probs = unet(local, t, cond, guidance_blocks=tuple(infer_cfg.motion_guidance_blocks),
                        frame_group=group)
        partial = infer_cfg.motion_guidance_weight * motion_guidance_loss(probs, rep, group)
    _, loss = fns.guided_step(local, t, tp, 1.0, uncond, cond, rep)
    torch.manual_seed(group.rank)
    pipe = MotionClonePipeline(unet_cfg, sched_cfg, infer_cfg, unet, device="cpu",
                               dtype=torch.float32, frame_group=group)
    return {
        "initial_latents": pipe.initial_latents(draw_seed),
        "rep": {k: (group.gather_frames(v, dim=3), group.gather_frames(i, dim=3))
                for k, (v, i) in rep.items()},
        "latents": group.gather_frames(latents),
        "partial_loss": float(partial),
        "loss": float(loss),
    }


class _Stop(Exception):
    pass


def _stop_at(steps):
    def on_chunk(done, total):
        if done == steps:
            raise _Stop
    return on_chunk


def _interrupted(fns, group, *args, **kw):
    """``fns.sample(*args, **kw)`` stopped by its ``on_chunk``, then a
    barrier: every rank has written its checkpoint."""
    try:
        fns.sample(*args, **kw)
    except _Stop:
        pass
    group.gather_frames(torch.zeros(1, 1))


def approx_resume_rank(group, state_dict, unet_cfg, sched_cfg, infer_cfg, video_latents,
                       noise, init, uncond, cond, workdir):
    """``sample`` under step-extrap:2 on the rank's frames, interrupted
    after the guided chunk with a resume path, then run again on it:
    returns the latents gathered over the ranks and the files the
    interrupted run left in ``workdir``.  Then, in chunks of one step, a
    run killed between the ranks' writes: rank 1's checkpoint one chunk
    behind rank 0's; the rerun's steps (the ranks must agree to start
    again from step 0) and whether it ends on an uninterrupted run's
    latents."""
    torch.set_num_threads(1)
    unet = UNet3DConditionModel(unet_cfg)
    unet.load_state_dict(state_dict, strict=True)
    unet.eval()
    fns = make_sampling_fns(unet, sched_cfg, infer_cfg, frame_group=group, step_interval=2,
                            step_extrap=1.0)
    rep = fns.extract(video_latents, noise, uncond)
    local = group.local_frames(init)
    path = os.path.join(workdir, "run.npz")
    _interrupted(fns, group, local, uncond, cond, rep, resume_path=path,
                 on_chunk=_stop_at(infer_cfg.guidance_steps))
    left = sorted(os.listdir(workdir))
    latents = fns.sample(local, uncond, cond, rep, resume_path=path)

    path = os.path.join(workdir, "behind.npz")
    mine, kept = f"{path}.rank{group.rank}.npz", os.path.join(workdir, "kept")
    _interrupted(fns, group, local, uncond, cond, rep, resume_path=path, chunk_steps=1,
                 on_chunk=_stop_at(1))
    if group.rank == 1:
        shutil.copy(mine, kept)
    _interrupted(fns, group, local, uncond, cond, rep, resume_path=path, chunk_steps=1,
                 on_chunk=_stop_at(2))
    if group.rank == 1:
        os.replace(kept, mine)
    with np.load(mine) as d:
        done = group.gather_frames(torch.tensor([int(d["steps_done"])]), dim=0)
    steps = []
    rerun = fns.sample(local, uncond, cond, rep, resume_path=path, chunk_steps=1,
                       on_step=lambda i, guided: steps.append(i))
    return {"latents": group.gather_frames(latents), "left": left,
            "behind_done": done.tolist(), "behind_steps": steps,
            "behind_equal": torch.equal(rerun, fns.sample(local, uncond, cond, rep,
                                                          chunk_steps=1))}


def failing_rank(group):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if group.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    group.gather_frames(torch.zeros(1, 1))
