"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded-only --shards 4 --backend nccl   # 4 cards

Phase 0  device: exits non-zero without CUDA; prints the card's name and
         power limit (nvidia-smi).
Phase 1  build: compiles motionclone_tpu_torch/csrc/*.cu with nvcc for
         sm_90a (one process per source) and prints the seconds it took.
Phase 2  kernels: each kernel at every shape the main path gives it (the
         rectangular temporal kernels 3r and 4r at 8, 4 and 2 query frames
         against 16, the local frames of 2, 4 and 8 shards), held against
         its plain PyTorch version on the same bf16 inputs over the whole
         batch, with times beside the bound (989 TFLOP/s bf16,
         3.35 TB/s).  The attention kernels (flash fwd/bwd, temporal
         fwd/bwd, square and rectangular) are also timed beside PyTorch's own
         attention as a yardstick that the port never calls:
         F.scaled_dot_product_attention for the forwards, the aten flash
         attention backward op (fed its own forward's out and LSE) for the
         backwards; temporal attention is handed to them as a strided
         (B, S*heads, F, D) view of its (B, F, S, heads*D) tensors; two
         launches of each flash and temporal kernel must give the same
         bits.  The fused modules (spatial transformer, transformer
         block, motion module, resnet) have no single PyTorch call to
         compare with; they are timed beside the port's unfused module on
         the same input, and two launches of kernel 8 must give the same
         bits.  Before them,
         the TMA + wgmma product of csrc/fused_product.cuh alone: first one
         64x160x64 tile, then every distinct (M, N, K, epilogue) kernels 5-7
         launch on the main path, each against its plain version (tolerance
         as the kernels'), two launches required to give the same bits,
         timed beside torch.matmul of the same operands (the product
         without its epilogue), with TFLOP/s and the bound; then kernel 8's
         3x3 convolution on that product (4-D tensor map over the video) at
         every distinct (M, Cout, 9·Cin, epilogue) of the main path, the
         same way, timed beside torch.nn.functional.conv2d (cuDNN) on the
         same operands.  Last, kernel 7 with one attention block and a
         32-row positional table (the SparseCtrl controlnet's motion
         modules) at the controlnet's four (S, C) where the kernel takes
         them, B = 1 and 2, against its plain version, beside the unfused
         module; the controlnet's products and convolutions are shapes
         the lists above already hold.  Each kernel of the sweep's path is
         also held at the largest shape phase 10's batch of 2 examples
         gives it: B·F = 64 (its CFG pair) for kernels 1, 5, 7 (the
         controlnet's too) and 8, B = 4 for the unfused motion modules'
         kernel 3, and B·F = 32 (its differentiated pass) for kernels 2
         and 4.  Last, the differentiable GroupNorm (+ SiLU) kernel pair
         (ops/group_norm.py) at every GROUP_NORM_SHAPES entry (the UNet's
         and the controlnet's per frame at the guided pass's B·F = 32, the
         VAE's per frame in its chunks of 4): forward and dx against the
         plain versions on the same bf16 inputs in f32 (within
         GN_FWD_RTOL of each output, GN_BWD_TOL of dx's largest), two
         launches of each giving the same bits, f32 at one shape, and
         timed beside their byte bound and the port's eager chain.
         SDXL's shapes (check_flash_kernels_xl, check_xl_kernels):
         kernels 1-2 at head dim 64, kernel 6 over a two-layer 640-wide
         transformer with 2048-wide text, kernel 7 at 128x128x320 and
         64x64x640, kernel 8 at the resnets SDXL's route gives it, and
         kernels 3-4 at S = 16384, 4096 and 1024, the same way.
Phase 3  main path: guided text-to-video sampling at SD1.5 + AnimateDiff v3
         width, 512x512x16 frames, random weights from a seed: CLIP on random
         token ids for the CFG pair, VAE encode of a random video,
         extraction, 2 guided + 2 vanilla DDIM steps (the t2v_camera schedule
         cut from 100 steps) on the default path (the fused modules), VAE
         decode.  Every output must be finite and of its shape, and each
         kernel of the path must have launched in this phase (the fused
         transformer block is off the SD1.5 path; phase 4 drives it).  Then
         steady guided and vanilla steps of the fused and the unfused
         ("flash") path, in turns, with their peak memory and the
         GroupNorm kernels' launches a step (the fused path's beside
         PREDICTED_GROUP_NORM_LAUNCHES; a guided step must launch both); and the
         unsharded results phase 6 compares with, beside a bf16 rounding
         control (the same math with other rounding: extraction as half of
         a batch of 2, sampling on the "flash" path).
Phase 3b SDXL's path: SDXL + AnimateDiff-SDXL (the benchmark's
         configuration file) at 1024x1024x16, random weights, text and
         latents from a seed: extraction, 2 guided (recompute on) and 2
         vanilla steps.  Every kernel's launches must be
         PREDICTED_XL_LAUNCHES', and every shape a kernel ran at one
         phase 2 held it at.
Phase 4  reference: the port on the card (bf16, kernels), on its default
         fused path and on its "flash" path, against the port on the CPU
         (f32, plain versions, unfused) at reduced depth and size; and one
         linear-projection Transformer3DModel, whose block is the fused
         transformer block, on the card against the CPU.  Then the i2v
         slice at the same depth for both SparseCtrl flavours (RGB: latent
         condition; sketch: pixel condition through the conv stack): the
         controlnet's residuals on the CFG pair, the conditioned
         extraction, one guided and one vanilla step, the card's fused
         path against the CPU.
Phase 5  only with ``--profile DIR``: one guided and one vanilla step of the
         main path's pipeline under torch.profiler: wall time, the device's
         busy and idle share, device time by category and the top kernels,
         and a chrome trace per step in DIR.
Phase 6  frame sharding: the main path of phase 3 (VAE decode on rank 0)
         over ``--shards`` frame shards (2), each rank a process of its own:
         with ``--backend gloo`` (the default) all on card 0, every K/V
         gather staged through host memory, so the step times say nothing
         of multi-GPU speed; with ``nccl`` rank r on card r.  Every rank
         must launch the predicted counts, 3r and 4r among them; rank 0's
         gathered latents, motion representation and summed loss must agree
         with phase 3's run within SHARD_TOLS, printed beside the rounding
         control.  ``--sharded-only`` runs phases 0, 1, 6 and 11 (with the
         unsharded run they compare with; phase 11 then writes its model
         directory itself) and prints no kernels line.

Phase 7  the t2v CLI: the port's ``cli.t2v_main`` on the card, as a user runs
         it, from a model directory written to a temporary directory: phase
         3's seeded random weights at SD1.5 + AnimateDiff v3 width saved in
         bf16 (diffusers-layout UNet without motion modules, a motion-module
         .ckpt with pos_encoder buffers, VAE, CLIP with Hugging Face keys),
         SD1.5's config.json files, a byte-level tokenizer, the repo's
         model_config.yaml and configs/t2v_camera.yaml with only its asset
         paths changed (100 steps, 50 guided), and a 16-frame 512x512
         reference clip as an mp4 (without cv2, the codec is stubbed in
         memory and a line says so).  Every loaded parameter must equal what
         was saved bit for bit, kernels 1, 2, 3, 4, 5, 7 and 8 must launch,
         the output must be 16 x 512 x 512 x 3 uint8, not constant, with the
         reference's name, and the motion representation's .npz must carry
         its meta; a second run must reuse it.  Prints the phase times, peak
         memory and seconds per video beside the card's name and power limit.
Phase 7b the assembler's optional merges, in phase 7's model directory:
         a DreamBooth LDM checkpoint (f16) whose UNet carries its non-EMA
         weights and differing ``model_ema.*`` shadows, a kohya image LoRA
         (two UNet linears, a UNet 1x1 conv, two CLIP linears) and two
         motion LoRAs (alphas 1.0 and 0.5), through
         ``weights.load.assemble_state_dicts(..., dreambooth_extract_ema=
         True)`` and ``load_into`` onto the card, where every key must equal
         its host reference bit for bit (the merges in f32, cast as the
         assembler casts them; the image layers the EMA shadows, never the
         non-EMA weights); then phase 3's 4-step cut on those weights, whose
         launches must equal ``predicted_launches`` and whose outputs must
         be finite.  Prints its seconds and peak memory.
Phase 8  the i2v CLI: ``cli.i2v_main`` on the card for both SparseCtrl
         flavours, from phase 7's model directory plus a random adapter
         LoRA (diffusers naming, every spatial q/k/v/out projection), a
         controlnet ``.ckpt`` per flavour at SD1.5 width (seeded random
         weights, pos_encoder buffers, an ``animatediff_config`` entry),
         configs/sparsectrl's YAMLs and a 512x512 condition PNG (the
         reference clip's first frame; image_index [0]); i2v_rgb with
         configs/i2v_rgb.yaml's full schedule (100 steps, 40 guided),
         i2v_sketch with configs/i2v_sketch.yaml's cut from 200 steps (120
         guided) to I2V_SKETCH_CUT, a line saying so.  Each run's launches
         must equal PREDICTED_I2V_LAUNCHES, the controlnet must run once in
         extraction and once per step with finite, non-zero residuals, the
         loaded controlnet must equal what was saved bit for bit and the
         adapter LoRA must have moved every target, and the output must be
         16 x 512 x 512 x 3 uint8, not constant, with the reference's name.
         Prints the phase times, ms per guided and vanilla step, peak
         memory and seconds per video beside the card's name and power
         limit.
Phase 9  the approx caches, the weights cache and resume through the CLIs,
         on phases 7's and 8's model directory: (a) ``cli.t2v_main`` with
         ``--approx step-extrap:3 --weights-cache DIR --resume`` at the full
         t2v_camera schedule (a miss), (b) with ``--approx
         uncond-extrap:3,guidance-cache:2`` (a hit: every parameter equal to
         phase 7's bit for bit), (d) (a)'s flags interrupted after the
         guided chunk and run again, which must end on (a)'s latents, (c)
         ``cli.i2v_main`` i2v_rgb with ``--approx step-extrap:3
         --weights-cache DIR`` twice (a miss, then a hit: the controlnet
         equal to phase 8's), one controlnet pass per full step and none per
         skip step.  Each run's launches must equal ``predicted_launches``
         from its schedule's flags (a skip step launches nothing), its video
         be 16 x 512 x 512 x 3 uint8 and not constant; (a) and (b) print
         their latents' relative L2 and their frames' PSNR against phase
         7's exact run (random weights: no quality figure).  (e), run inside
         phase 3: phase 3's exact sampling and the build with every cache
         on and every override at 1, each against the exact steps driven
         one at a time.  (d) and (e) must be bit for bit,
         or within RERUN_TOL where the card's kernels give other bits for
         the same inputs, which a line then says.  Prints the load seconds
         without the cache, cold and warm, and per run the seconds per
         video, the full and skip step medians and peak memory beside the
         card's name and power limit.
Phase 10 the sweep and the server, on phases 7-9's model directory and
         weights cache: (a) ``cli.sweep_main`` (``python3 -m
         motionclone_tpu_torch.sweep``) on 2 examples, the reference clip
         under two prompts and seeds, at ``--num-devices 2``: one batch at
         the full t2v_camera schedule, whose launches must equal
         ``predicted_launches`` (a batch launches each kernel once per
         pass), with one CLIP call, two 16 x 512 x 512 x 3 uint8 videos with
         the reference's names, and each example's final latents within
         BATCH_TOL of the example run alone (the first: phase 7's run; the
         second runs now), printed beside a rounding control (phase 7's
         example alone from initial latents one bf16 ulp away); prints the
         seconds per batch and per video, the step medians at batch 2 and
         peak memory.  (b) the same batch with the schedule cut to
         SWEEP_CUT: a representation-cache hit (no VAE encode, no
         extraction).  (c) (b) with ``--resume``, interrupted after the
         guided chunk and run again, must end on (b)'s latents (bit for
         bit, or within RERUN_TOL with a line saying so).  (d) an i2v_rgb
         batch of 2 with the controlnet scales I2V_SWEEP_SCALES, cut to
         I2V_SWEEP_CUT: the controlnet runs once per step on 4 rows, its
         residuals are finite and each example's are its own scale times
         the unit-scale ones.  (e) ``cli.serve_main`` on 127.0.0.1, port 0,
         in a thread, cut to SWEEP_CUT, ``--batch-max 2``: 3 POSTed jobs,
         the first alone on the single path and the other two as one
         batch, a malformed body answered 400, every job done with its
         video, ``/health`` and ``/metrics`` read; then the server is
         stopped and every thread it started joined.  Each cut run prints
         a line saying so.
Phase 11 the multi-device layouts through the CLIs, each run ``python3 -m
         torch.distributed.run --standalone --nproc-per-node R`` over this
         script in its ``--layout-rank`` mode (which calls the CLI with the
         launch counts set to 0 just before and read just after), at
         ``--frame-shard 2 --dist-backend gloo --device cuda:0`` (ranks
         sharing card 0: no speed figure; ``--backend nccl``: ``--device
         cuda``, one card per rank, which (b) and (d) need 4 of) on phases
         7-10's model directory and weights cache, every schedule cut to
         LAYOUT_CUT, 2 steps, 1 guided (a line says so): (a) ``t2v_main``
         (2 ranks), (b)
         ``t2v_main --cfg-pair`` (4 ranks: (cfg, frames)), (c) ``i2v_main``
         i2v_rgb (2 ranks; the controlnet's motion modules on kernel 3r),
         (d) ``sweep_main`` on 2 examples (4 ranks: data 2 x frames 2), (e)
         ``serve_main`` with one job POSTed to rank 0's server, which is
         then stopped; (a), (c), (e) in one torchrun call and (b), (d) in
         another, each call's later CLIs on the world its first one joins.
         Each rank's launches must equal
         ``predicted_layout_launches`` (its CFG half's under (b)); every
         rank of a video must gather the same latents, within SHARD_TOLS
         of the unsharded CLI run at the same cut (run first, in this
         process), printed beside phase 3's rounding control; each example
         one 16 x 512 x 512 x 3 uint8 mp4, not constant, under the
         reference's name; (e) equal to (a) bit for bit (or within
         RERUN_TOL, said so); torchrun must exit 0 and leave no process.
         Each call's line splits its seconds (torchrun and imports, the
         CLI, the exit), each rank's its load by step.

Phase 12 plain generation and the parity harness, on phase 3's pipeline
         (rebuilt from its seed) and phases 7-11's model directory: (a)
         ``sample_latents_plain`` at configs/t2v_camera.yaml's 100 steps on
         the "leading" schedule, whose launches must equal
         ``predicted_launches`` of its plain schedule (a vanilla step's
         each); prints the seconds, the ms-per-step median (CUDA events)
         and peak memory.  (b) its ``save_probs_path`` dump at phase 3's
         4-step cut: launches equal to ``predicted_probs_launches`` (the
         guidance blocks' motion modules leave their kernel for the plain
         probability route), one map per guidance module of (4, 2, S,
         heads, 16, 16) float32 whose rows sum to 1 within 1e-3, the
         latents within RERUN_TOL of the undumped run; prints the dump's
         host bytes.  (c) ``pipeline.parity.run_parity(workloads=("rgb",))``
         with phase 8's i2v_rgb config and example as
         ``<root>/configs/i2v_rgb.{yaml,jsonl}``, scored against phase 8's
         video (same seed, 76739): one generated, one matched, PSNR and
         SSIM at least PARITY_LIMITS.  The kernels line's ``plain_launches``
         are (a)'s.

The line before the last is the kernels JSON; the last line is the result
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result.  On its way out, whatever the outcome,
the script stops every process it started that is still running
(multiprocessing's resource tracker, which phase 6's spawned ranks start,
and any descendant, orphans included: the script adopts them as a child
subreaper) and names each on standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# H100 SXM special-function unit: exponentials per second (FlashAttention-3,
# Shah et al. 2024: "3.9 TFLOPS of special functions")
PEAK_EXP = 3.9e12
TEXT_TOKENS = 77          # CLIP's sequence: the cross-attention's keys

# (S, head dim) of the spatial and temporal attentions at 512x512 latents
# (64x64, 32x32, 16x16, 8x8 with 320/640/1280/1280 channels over 8 heads)
ATTN_SHAPES = ((4096, 40), (1024, 80), (256, 160), (64, 160))
HEADS = 8
# tolerance of a bf16 kernel against its f32-math plain version on the same
# bf16 inputs: bf16 rounds P before the P@V product and every output at
# 2**-8 relative, so errors scale with the output's magnitude
RTOL = 2e-2
ATOL = 2e-3
FRAMES = 16
# local query frames of the rectangular temporal kernels at 2, 4 and 8 shards
RECT_QUERY_FRAMES = (8, 4, 2)
# (H = W, C) of the fused spatial transformer and motion module at 512x512
FUSED_SHAPES = ((64, 320), (32, 640))
# B·F of the sweep's batch of 2 examples (phase 10): a CFG half, the pair
BATCH2_HALF, BATCH2_PAIR = 2 * FRAMES, 4 * FRAMES
# (H = W, Cin, Cout) of every resnet the fused route takes at 512x512
RESNET_SHAPES = ((64, 320, 320), (64, 960, 320), (64, 640, 320),
                 (32, 320, 640), (32, 640, 640), (32, 1920, 640),
                 (32, 1280, 640), (32, 960, 640), (16, 640, 1280))
# (samples, pixels a sample, channels, SiLU) of every GroupNorm that runs
# the differentiable kernels at 512x512x16 (ops/group_norm.py): the UNet's
# per frame at the guided pass's B·F = 32 (every module before the cut;
# the controlnet's are its down and mid blocks', shapes of this list), and
# the VAE's per frame in its chunks of 4 frames (encode and decode)
GROUP_NORM_SHAPES = tuple(
    [(2 * FRAMES, s, c, silu) for s, c, silu in (
        (4096, 320, True), (4096, 320, False), (4096, 640, True), (4096, 960, True),
        (1024, 320, True), (1024, 640, True), (1024, 640, False), (1024, 960, True),
        (1024, 1280, True), (1024, 1920, True),
        (256, 640, True), (256, 1280, True), (256, 1280, False), (256, 1920, True),
        (256, 2560, True),
        (64, 1280, True), (64, 1280, False), (64, 2560, True))]
    + [(4, s, c, silu) for s, c, silu in (
        (262144, 128, True), (262144, 256, True), (65536, 128, True), (65536, 256, True),
        (65536, 512, True), (16384, 256, True), (16384, 512, True), (4096, 512, True),
        (4096, 512, False))])
# the kernels against their plain versions in f32 on the same bf16 inputs:
# the forward rounds each output once to bf16 (at most half an ulp, 2**-8
# of it), dx too, after f32 arithmetic in another order (far below bf16's
# ulp): each within one ulp; in f32 within 2e-5 and 1e-4 of the largest
# output (the kernel's rsqrtf and __expf against torch's)
GN_FWD_RTOL = 2.0**-7
GN_BWD_TOL = 2.0**-7  # of dx's largest magnitude
# the GroupNorm kernels' launches a step of the fused path (forward,
# backward): the unconditional pass's 39 unfused GroupNorms (the resnets,
# transformers and motion modules at 16x16 and 8x8 that kernels 5, 7 and 8
# do not take, and conv_norm_out) and the conditional pass's 57 (every
# module up to the cut after up_blocks.1, and conv_norm_out without grad),
# 56 of them differentiated; a vanilla step: one pass
PREDICTED_GROUP_NORM_LAUNCHES = {"guided": (96, 56), "vanilla": (39, 0)}
# launches predicted from the JAX package's routing for extraction + 2
# guided + 2 vanilla steps (extraction / per guided step / per vanilla step)
PREDICTED_LAUNCHES = {
    "fused_spatial_transformer": (0, 16, 10), "fused_temporal_module": (0, 16, 10),
    "fused_resnet_block": (0, 17, 11), "flash_fwd": (10, 16, 6),
    "flash_bwd": (0, 10, 0), "temporal_fwd": (22, 42, 20), "temporal_bwd": (0, 22, 0),
    "fused_transformer_block": (0, 0, 0),
    "temporal_fwd_rect": (0, 0, 0), "temporal_bwd_rect": (0, 0, 0),
}
# one pass of the SparseCtrl controlnet at SD1.5 width, 512x512, 16 frames,
# at batch 1 (extraction) or 2 (the CFG pair of every sampling step), on
# the fused path: the UNet's down and mid half, so its modules route as the
# UNet's down blocks do (fused_resnet.supported / device_supported,
# fused_block.supported, fused_temporal.supported: C <= 640).  Kernel 5: the
# spatial transformers of down_blocks.0 and .1 (4); kernel 7 with one
# attention block: their motion modules (4); kernel 8: the resnets at
# (64, 320->320) x 2, (32, 320->640), (32, 640->640), (16, 640->1280) (5);
# the unfused transformers of down_blocks.2 and the mid block run kernel 1
# for their self-attention (3); the unfused motion modules of down_blocks.2
# and .3 run kernel 3 once each, one attention block (4).  The mid block has
# no motion module (motion_module_mid_block: false).
PREDICTED_CONTROLNET_LAUNCHES = {
    "fused_spatial_transformer": 4, "fused_temporal_module": 4, "fused_resnet_block": 5,
    "flash_fwd": 3, "temporal_fwd": 4,
}
# the i2v CLI's launches (extraction / per guided step / per vanilla step):
# the t2v path's plus one controlnet pass in extraction and in every step
PREDICTED_I2V_LAUNCHES = {
    name: tuple(n + PREDICTED_CONTROLNET_LAUNCHES.get(name, 0) for n in counts)
    for name, counts in PREDICTED_LAUNCHES.items()
}
# the same per rank of the frame-sharded path (phase 6), whatever the number
# of shards: every temporal attention is rectangular, and the fused motion
# module is off
PREDICTED_SHARDED_LAUNCHES = {
    "fused_spatial_transformer": (0, 16, 10), "fused_temporal_module": (0, 0, 0),
    "fused_resnet_block": (0, 17, 11), "flash_fwd": (10, 16, 6),
    "flash_bwd": (0, 10, 0), "temporal_fwd": (0, 0, 0), "temporal_bwd": (0, 0, 0),
    "fused_transformer_block": (0, 0, 0),
    "temporal_fwd_rect": (22, 74, 40), "temporal_bwd_rect": (0, 22, 0),
}
# kernels that no run of the main path launches: kernel 6 is the
# linear-projection models' route (SDXL's: phase 2 holds it at SDXL's
# shapes, phase 3b counts its launches on SDXL's path), the rectangular
# kernels the frame-sharded path's (phase 6)
OFF_MAIN_PATH = ("fused_transformer_block", "temporal_fwd_rect", "temporal_bwd_rect")
# phase 6 holds the sharded run against the unsharded one on the card: the
# fused motion module (unsharded) and the unfused rectangular attention
# (sharded) round to bf16 at different points, and every product runs on the
# rank's frames only, with other shapes and so other rounding, which the
# random weights amplify over the depth (phase 3's rounding control deviates
# as much); bf16 near-ties can flip an argmax
SHARD_TOLS = {"latents_rel_l2": 5e-2, "rep_values_rel_l2": 3e-2,
              "rep_indices_equal_share": 0.95, "loss_rel": 5e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def adopt_orphans() -> None:
    """Make this process the child subreaper of its descendants (Linux
    prctl PR_SET_CHILD_SUBREAPER), so that a process whose parent exits is
    re-parented here rather than to init, and :func:`stop_descendants` still
    finds it."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def descendants() -> list:
    """(pid, command line) of every living process below this one, from
    /proc, parents before their children."""
    children = defaultdict(list)
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                # after the command's closing parenthesis: state, ppid
                state, ppid = fh.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if state != "Z":
            children[int(ppid)].append(int(entry))
    out, todo = [], [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), ()):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as fh:
                    cmd = fh.read().replace(b"\0", b" ").decode(errors="replace").strip()
            except OSError:
                cmd = "?"
            out.append((pid, cmd))
            todo.append(pid)
    return out


def stop_descendants(limit_s: float = 10.0) -> None:
    """Stop every process this script started that still runs: the
    multiprocessing resource tracker (closing its pipe ends it; it ignores
    SIGTERM), then any other descendant (SIGKILL), each named on standard
    error; wait until none is left and reap the exited children."""
    import signal
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    try:
        pid = tracker._pid
        tracker._stop()
        if pid is not None:
            print(f"chip_smoke: stopped multiprocessing's resource tracker (pid {pid})",
                  file=sys.stderr)
    except Exception as exc:  # noqa: BLE001 - report and go on to the kill
        print(f"chip_smoke: resource tracker: {exc!r}", file=sys.stderr)
    deadline = time.monotonic() + limit_s
    while True:
        left = descendants()
        if not left:
            break
        for pid, cmd in left:
            print(f"chip_smoke: stopping process {pid} left running: {cmd[:200]}",
                  file=sys.stderr, flush=True)
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if time.monotonic() > deadline:
            print(f"chip_smoke: {len(left)} processes still running after "
                  f"{limit_s:.0f} s", file=sys.stderr)
            break
        time.sleep(0.1)
        while True:  # reap the children that exited (kills included)
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    break
            except ChildProcessError:
                break


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


def attention_recorder(rows: dict):
    """The attention kernels' ``record``: logs one shape's line, raises if
    the error passes the tolerance, and keeps the main path's largest shape
    (S = 4096) of each kernel in ``rows`` for the kernels JSON line."""

    def record(name, shape, err, tol, ms, plain_ms, b_ms, b_by, lib_ms, lib_dev,
               exp_ms=None):
        ok = err <= tol
        floor = "" if exp_ms is None else f" exp_floor_ms={exp_ms:.4f}"
        log(
            f"kernel {name:13s} shape={shape} max_abs_err={err:.3e} tol={tol:.3e} "
            f"{'OK' if ok else 'FAIL'} kernel_ms={ms:.4f} plain_ms={fmt(plain_ms)} "
            f"bound_ms={b_ms:.4f} ({b_by}){floor} library_ms={fmt(lib_ms)} "
            f"library_vs_kernel={lib_dev:.3e}"
        )
        if not ok:
            raise AssertionError(f"{name} at {shape}: error {err} > tolerance {tol}")
        # the JSON line carries the 64x64 (S=4096) shape: the main path's largest
        if shape[-2 if name.startswith("temporal") else 1] == 4096 and name not in rows:
            rows[name] = dict(shape=list(shape), max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms)

    return record


def check_kernels(dev) -> dict:
    """Kernels 1-4 (flash and temporal attention, and 3r, 4r) at every
    main-path shape against their plain versions, timed beside PyTorch's
    own attention; kernels 1-2 also at SDXL's head dim 64."""
    rows = check_flash_kernels(dev)
    rows.update(check_flash_kernels_xl(dev))
    rows.update(check_temporal_kernels(dev))
    return rows


# (B*F, S, heads) of SDXL's spatial self-attention at 1024x1024 latents of
# 16 frames, head dim 64: 640 channels over 10 heads at 64x64 (unfused in
# the differentiated pass only), 1280 over 20 at 32x32 (unfused in every
# pass: B*F = 32 is the vanilla pair's)
XL_ATTN_SHAPES = ((16, 4096, 10), (16, 1024, 20), (32, 1024, 20))
# SDXL + AnimateDiff-SDXL (the configuration of the t2v_camera_xl.b1 cell)
# at 1024x1024 latents of 16 frames, batch 1: the shapes each module's
# fused_route gives kernels 6-8, which run only in the passes without grad,
# at B*F = 16 (the guided step's unconditional pass, its conditional pass
# past the cut) and 32 (the vanilla pair).  Kernel 6: the 640-wide
# transformers at 64x64 (10 heads of 64, 2 layers, 2048-wide text); the
# 1280-wide ones run unfused (C > 640).  Kernel 7: the motion modules at
# 128x128x320 and 64x64x640.  Kernel 8: the resnets it takes, (H = W, Cin,
# Cout); none at 128x128 (a frame passes 24 MB), none from 1280 input
# channels at 64x64 or from 1280 at 32x32 (weights past 48 MB).
XL_CONFIG = "bench_h100/configs/sdxl-adxl-t2v.json"
XL_BLOCK = (64, 640, 10, 2, 2048)  # H = W, C, heads, layers, text width
XL_TEMPORAL_FUSED = ((128, 320), (64, 640))
XL_RESNET_SHAPES = ((64, 320, 640), (64, 640, 640), (64, 960, 640), (32, 640, 1280))
# kernels 3-4 (8 heads) in the unfused motion modules: (S, head dim, the
# forward's batches); at 320 and 640 channels in the differentiated pass
# only (B = 1, forward and backward), at 1280 in every pass (the forward
# at B = 1 and 2, the backward at 1)
XL_TEMPORAL_SHAPES = ((16384, 40, (1,)), (4096, 80, (1,)), (1024, 160, (1, 2)))
# launches on SDXL's path (phase 3b: extraction + 2 guided + 2 vanilla
# steps; extraction / per guided step / per vanilla step).  A full pass
# without grad: kernel 8 in down_blocks.1 (2), down_blocks.2's first
# resnet and up_blocks.1's last; kernel 6 in down_blocks.1 (2 x 2 layers)
# and up_blocks.1 (3 x 2); kernel 7 in the 320- and 640-wide blocks (10);
# the 1280-wide motion modules' kernel 3 (5 x 2 attention blocks) and
# transformers' kernel 1 (60 layers).  The conditional pass runs unfused to
# the cut (up_blocks.0): kernel 1 in 64 layers, again in their recompute,
# kernel 2 in each; kernels 3-4 in 6 motion modules (up_blocks.0's 3 return
# their probabilities by the plain route); then up_blocks.1 (kernel 8 once,
# kernel 6 6 times, kernel 7 3 times) and up_blocks.2 (kernel 7 3 times)
# fused.  Extraction runs the conditional pass's unfused part without grad.
PREDICTED_XL_LAUNCHES = {
    "fused_spatial_transformer": (0, 0, 0), "fused_transformer_block": (0, 16, 10),
    "fused_temporal_module": (0, 16, 10), "fused_resnet_block": (0, 5, 4),
    "flash_fwd": (64, 188, 60), "flash_bwd": (0, 64, 0),
    "temporal_fwd": (12, 22, 10), "temporal_bwd": (0, 12, 0),
    "temporal_fwd_rect": (0, 0, 0), "temporal_bwd_rect": (0, 0, 0),
}


def check_flash_kernels_xl(dev) -> dict:
    """Kernels 1 and 2 at head dim 64 (``XL_ATTN_SHAPES``) against their
    plain versions, twice for the same bits, timed beside PyTorch's own
    attention (SDPA forward, the aten flash backward); rows keyed
    ``flash_fwd_d64`` / ``flash_bwd_d64`` and the shape's B*F and S."""
    from torch.nn import functional as F

    from motionclone_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(0)
    rows, d = {}, 64

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    for b, s, heads in XL_ATTN_SHAPES:
        hd, scale = heads * d, d ** -0.5
        view = lambda x: x.view(b, s, heads, d).transpose(1, 2)
        q, k, v, dout = (randn(b, s, hd) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, heads, scale)
        grads = fa.flash_bwd(q, k, v, out, lse, dout, heads, scale)
        again = fa.flash_fwd(q, k, v, heads, scale), fa.flash_bwd(q, k, v, out, lse, dout,
                                                                  heads, scale)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0][0]) and torch.equal(lse, again[0][1])
                and all(torch.equal(g, a) for g, a in zip(grads, again[1]))):
            raise AssertionError(f"flash at head dim 64: two launches differ at {(b, s, heads)}")
        del again
        got_f, ref_f, got_b, ref_b = [], [], [], []
        for sl in batch_slices(b, 2):
            got_f.append(out[sl])
            ref_f.append(fa.flash_attention_plain(q[sl], k[sl], v[sl], heads, scale)[0])
            got_b.extend(g[sl] for g in grads)
            ref_b.extend(fa.flash_attention_bwd_plain(q[sl], k[sl], v[sl], dout[sl], heads,
                                                      scale))
        for name, (got, ref), ms, lib_ms, lib_dev, (b_ms, b_by) in (
                ("flash_fwd", (got_f, ref_f),
                 time_ms(lambda: fa.flash_fwd(q, k, v, heads, scale)),
                 time_ms(lambda: F.scaled_dot_product_attention(view(q), view(k), view(v),
                                                                scale=scale)),
                 (F.scaled_dot_product_attention(view(q), view(k), view(v), scale=scale)
                  .transpose(1, 2).reshape(b, s, hd).float() - out.float()).abs().max().item(),
                 bound(4 * b * s * s * hd, 4 * b * s * hd * 2 + b * heads * s * 4)),
                ("flash_bwd", (got_b, ref_b),
                 time_ms(lambda: fa.flash_bwd(q, k, v, out, lse, dout, heads, scale)),
                 *_library_bwd_xl(view, q, k, v, dout, grads, scale),
                 bound(10 * b * s * s * hd, 8 * b * s * hd * 2 + b * heads * s * 4))):
            err, tol = max_err(got, ref)
            ok = err <= tol
            log(f"kernel {name:13s} shape={(b, s, heads, d)} max_abs_err={err:.3e} "
                f"tol={tol:.3e} {'OK' if ok else 'FAIL'} kernel_ms={ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) roofline={100 * b_ms / ms:.1f}% "
                f"library_ms={lib_ms:.4f} library_vs_kernel={lib_dev:.3e}")
            if not ok:
                raise AssertionError(f"{name} at {(b, s, heads, d)}: error {err} > {tol}")
            rows[f"{name}_d64_b{b}_s{s}"] = dict(shape=[b, s, heads, d], max_abs_err=err,
                                                ms=ms, bound_ms=b_ms, bound_by=b_by,
                                                library_ms=lib_ms)
        del got_f, ref_f, got_b, ref_b, grads
        torch.cuda.empty_cache()
    return rows


def _library_bwd_xl(view, q, k, v, dout, grads, scale):
    """(ms, largest gap to ``grads``) of PyTorch's flash backward on the
    4-D views of (B, S, heads*D) tensors."""
    lib_ms, lib_grads = library_bwd(view(q), view(k), view(v), view(dout), scale)
    gap = max((lg.transpose(1, 2).reshape(g.shape).float() - g.float()).abs().max().item()
              for lg, g in zip(lib_grads, grads))
    return lib_ms, gap


def check_flash_kernels(dev) -> dict:
    from torch.nn import functional as F

    from motionclone_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    rows = {}

    record = attention_recorder(rows)

    def exp_floor(b, sq, sk):  # one exponential per score, the least any algorithm needs
        return b * HEADS * sq * sk / PEAK_EXP * 1e3

    for s, d in ATTN_SHAPES:
        hd = HEADS * d
        scale = d ** -0.5
        # flash forward, B*F = 16 (one CFG half) and 32 (the vanilla pair),
        # and the sweep's batch of 2 examples, 64 (its pair): the
        # self-attention (Sk = S), then the cross-attention against the 77
        # text tokens (the ragged last key tile)
        for sk, b in ((s, 16), (s, 32), (s, BATCH2_PAIR), (TEXT_TOKENS, 16),
                      (TEXT_TOKENS, 32), (TEXT_TOKENS, BATCH2_PAIR)):
            q, k, v = randn(b, s, hd), randn(b, sk, hd), randn(b, sk, hd)
            out, lse = fa.flash_fwd(q, k, v, HEADS, scale)
            again = fa.flash_fwd(q, k, v, HEADS, scale)
            torch.cuda.synchronize()
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                raise AssertionError(f"flash_fwd: two launches differ at {(b, s, sk, hd)}")
            del again
            got, ref, lse_err = [], [], 0.0
            for sl in batch_slices(b, 4 if s == 4096 else b):
                ref_out, ref_lse = fa.flash_attention_plain(q[sl], k[sl], v[sl], HEADS, scale)
                got.append(out[sl])
                ref.append(ref_out)
                lse_err = max(lse_err, (lse[sl] - ref_lse).abs().max().item())
            err, tol = max_err(got, ref)
            if lse_err > 1e-2:
                raise AssertionError(f"flash_fwd lse error {lse_err} at {(b, s, sk, hd)}")
            del got, ref, ref_out, ref_lse
            ms = time_ms(lambda: fa.flash_fwd(q, k, v, HEADS, scale))
            plain_ms = None  # the plain (B, heads, S, S) f32 logits would pass 40 GB
            if b * s * sk <= 16 * 4096 * 4096:
                plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, HEADS, scale),
                                   reps=3, warmup=1)
            q4 = flash_view(q, b, s, d)
            k4, v4 = (flash_view(x, b, sk, d) for x in (k, v))
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            lib_ms = time_ms(lib)
            lib_dev = (lib().transpose(1, 2).reshape(b, s, hd).float() - out.float()).abs().max().item()
            b_ms, b_by = bound(4 * b * s * sk * hd,
                               (2 * b * s * hd + 2 * b * sk * hd) * 2 + b * HEADS * s * 4)
            shape = (b, s, HEADS, d) if sk == s else (b, s, sk, HEADS, d)
            record("flash_fwd", shape, err, tol, ms, plain_ms, b_ms, b_by, lib_ms, lib_dev,
                   exp_floor(b, s, sk))
            torch.cuda.empty_cache()

        # flash backward, B*F = 16 (the cond pass) and 32 (the sweep's
        # batch of 2 examples)
        for b in (16, BATCH2_HALF):
            q, k, v, dout = (randn(b, s, hd) for _ in range(4))
            out, lse = fa.flash_fwd(q, k, v, HEADS, scale)
            grads = fa.flash_bwd(q, k, v, out, lse, dout, HEADS, scale)
            again = fa.flash_bwd(q, k, v, out, lse, dout, HEADS, scale)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(grads, again)):
                raise AssertionError(f"flash_bwd: two launches differ at {(b, s, hd)}")
            del again
            got, ref = [], []
            for sl in batch_slices(b, 2 if s == 4096 else b):
                got.extend(g[sl] for g in grads)
                ref.extend(fa.flash_attention_bwd_plain(q[sl], k[sl], v[sl], dout[sl], HEADS,
                                                        scale))
            err, tol = max_err(got, ref)
            del got, ref
            ms = time_ms(lambda: fa.flash_bwd(q, k, v, out, lse, dout, HEADS, scale))
            plain_ms = None  # the plain backward's f32 logits and their grads: 50 GB at 32
            if b * s * s <= 16 * 4096 * 4096:
                plain_ms = time_ms(
                    lambda: fa.flash_attention_bwd_plain(q, k, v, dout, HEADS, scale),
                    reps=2, warmup=1,
                )
            lib_ms, lib_grads = library_bwd(*(flash_view(x, b, s, d) for x in (q, k, v, dout)),
                                            scale)
            lib_dev = max((lg.transpose(1, 2).reshape(b, s, hd).float() - g.float())
                          .abs().max().item() for lg, g in zip(lib_grads, grads))
            del lib_grads, grads
            b_ms, b_by = bound(10 * b * s * s * hd,
                               (8 * b * s * hd) * 2 + b * HEADS * s * 4)
            record("flash_bwd", (b, s, HEADS, d), err, tol, ms, plain_ms, b_ms, b_by,
                   lib_ms, lib_dev, exp_floor(b, s, s))
            torch.cuda.empty_cache()
    return rows


def check_temporal_kernels(dev) -> dict:
    """Kernels 3, 4, 3r and 4r at every main-path shape (the rectangular ones
    at 8, 4 and 2 query frames) against their plain versions over the whole
    batch, two launches of each required to give the same bits, timed
    beside PyTorch's attention on strided views."""
    from torch.nn import functional as F

    from motionclone_tpu_torch.ops import temporal_attention as ta

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def same_bits(name, shape, first, fn):
        again = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"{name}: two launches differ at {shape}")

    rows = {}
    record = attention_recorder(rows)
    for s, d in ATTN_SHAPES:
        hd = HEADS * d
        scale = d ** -0.5
        # temporal forward, batch 1 (one CFG half), 2 (the vanilla pair, or
        # a half of the sweep's batch of 2 examples) and 4 (that batch's
        # pair, the unfused motion modules at 1280 channels)
        f = 16
        for b in (1, 2, 4):
            q, k, v = (randn(b, f, s, hd) for _ in range(3))
            out, lse = ta.temporal_fwd(q, k, v, HEADS, scale)
            same_bits("temporal_fwd", (b, f, s, hd), (out, lse),
                      lambda: ta.temporal_fwd(q, k, v, HEADS, scale))
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

        # temporal backward, batch 1 (the cond pass) and 2 (the sweep's
        # batch of 2 examples)
        for b in (1, 2):
            q, k, v, dout = (randn(b, f, s, hd) for _ in range(4))
            _, lse = ta.temporal_fwd(q, k, v, HEADS, scale)
            grads = ta.temporal_bwd(q, k, v, lse, dout, HEADS, scale)
            same_bits("temporal_bwd", (b, f, s, hd), grads,
                      lambda: ta.temporal_bwd(q, k, v, lse, dout, HEADS, scale))
            ref = ta.temporal_attention_bwd_plain(q, k, v, dout, HEADS, scale)
            err, tol = max_err(grads, ref)
            ms = time_ms(lambda: ta.temporal_bwd(q, k, v, lse, dout, HEADS, scale), reps=20)
            plain_ms = time_ms(
                lambda: ta.temporal_attention_bwd_plain(q, k, v, dout, HEADS, scale))
            lib_ms, lib_grads = library_bwd(
                *(temporal_view(x, b, f, s, d) for x in (q, k, v, dout)), scale)
            lib_dev = max((lg.transpose(1, 2).reshape(b, f, s, hd).float() - g.float())
                          .abs().max().item() for lg, g in zip(lib_grads, grads))
            b_ms, b_by = bound(10 * b * s * HEADS * f * f * d,
                               (7 * b * f * s * hd) * 2 + b * s * HEADS * f * 4)
            record("temporal_bwd", (b, f, s, hd), err, tol, ms, plain_ms, b_ms, b_by,
                   lib_ms, lib_dev)
        torch.cuda.empty_cache()

        # the rectangular forms: FQ local query frames against the 16
        # gathered key/value frames, batch 1 (a CFG half) and 2 (the pair)
        for fq in RECT_QUERY_FRAMES:
            for b in (1, 2):
                q, dout = randn(b, fq, s, hd), randn(b, fq, s, hd)
                k, v = randn(b, f, s, hd), randn(b, f, s, hd)
                out, lse = ta.temporal_fwd_rect(q, k, v, HEADS, scale)
                grads = ta.temporal_bwd_rect(q, k, v, lse, dout, HEADS, scale)
                same_bits("temporal_fwd_rect", (b, fq, s, hd), (out, lse),
                          lambda: ta.temporal_fwd_rect(q, k, v, HEADS, scale))
                same_bits("temporal_bwd_rect", (b, fq, s, hd), grads,
                          lambda: ta.temporal_bwd_rect(q, k, v, lse, dout, HEADS, scale))
                ref_out, ref_lse = ta.temporal_attention_plain(q, k, v, HEADS, scale)
                err, tol = max_err((out,), (ref_out,))
                lse_err = (lse - ref_lse).abs().max().item()
                if lse_err > 1e-2:
                    raise AssertionError(f"temporal_fwd_rect lse error {lse_err} at "
                                         f"{(b, fq, s, hd)}")
                ms = time_ms(lambda: ta.temporal_fwd_rect(q, k, v, HEADS, scale), reps=20)
                plain_ms = time_ms(lambda: ta.temporal_attention_plain(q, k, v, HEADS, scale))
                q4, k4, v4 = (temporal_view(x, b, x.shape[1], s, d) for x in (q, k, v))
                lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
                lib_ms = time_ms(lib, reps=20)
                lib_dev = (lib().transpose(1, 2).reshape(b, fq, s, hd).float()
                           - out.float()).abs().max().item()
                # bytes: q, k, v, out and lse once each
                b_ms, b_by = bound(4 * b * s * HEADS * fq * f * d,
                                   (2 * fq + 2 * f) * b * s * hd * 2 + b * s * HEADS * fq * 4)
                record("temporal_fwd_rect", (b, fq, s, hd), err, tol, ms, plain_ms, b_ms,
                       b_by, lib_ms, lib_dev)

                ref = ta.temporal_attention_bwd_plain(q, k, v, dout, HEADS, scale)
                err, tol = max_err(grads, ref)
                ms = time_ms(lambda: ta.temporal_bwd_rect(q, k, v, lse, dout, HEADS, scale),
                             reps=20)
                plain_ms = time_ms(
                    lambda: ta.temporal_attention_bwd_plain(q, k, v, dout, HEADS, scale))
                lib_ms, lib_grads = library_bwd(
                    q4, k4, v4, temporal_view(dout, b, fq, s, d), scale)
                lib_dev = max((lg.transpose(1, 2).reshape(g.shape).float() - g.float())
                              .abs().max().item() for lg, g in zip(lib_grads, grads))
                # bytes: q, k, v, dout and lse read, dq, dk, dv written
                b_ms, b_by = bound(10 * b * s * HEADS * fq * f * d,
                                   (3 * fq + 4 * f) * b * s * hd * 2 + b * s * HEADS * fq * 4)
                record("temporal_bwd_rect", (b, fq, s, hd), err, tol, ms, plain_ms, b_ms,
                       b_by, lib_ms, lib_dev)
        torch.cuda.empty_cache()

    # off the main path: a width the 160-channel tiles do not divide (6
    # heads of 40: a tile of 4 heads, then one of 2)
    for fq in (16, 8):
        q, dout = randn(1, fq, 64, 240), randn(1, fq, 64, 240)
        k, v = randn(1, 16, 64, 240), randn(1, 16, 64, 240)
        rect = "_rect" if fq != 16 else ""
        out, lse = getattr(ta, "temporal_fwd" + rect)(q, k, v, 6, 40 ** -0.5)
        grads = getattr(ta, "temporal_bwd" + rect)(q, k, v, lse, dout, 6, 40 ** -0.5)
        ref_out, ref_lse = ta.temporal_attention_plain(q, k, v, 6, 40 ** -0.5)
        errs = [max_err((out,), (ref_out,)),
                max_err(grads, ta.temporal_attention_bwd_plain(q, k, v, dout, 6, 40 ** -0.5))]
        lse_err = (lse - ref_lse).abs().max().item()
        log(f"kernel temporal_fwd{rect}/bwd{rect} shape={(1, fq, 64, 240)} (6 heads of 40) "
            f"max_abs_err={errs[0][0]:.3e}/{errs[1][0]:.3e} tol={errs[0][1]:.3e}/"
            f"{errs[1][1]:.3e} lse_err={lse_err:.3e}")
        if any(e > t for e, t in errs) or lse_err > 1e-2:
            raise AssertionError(f"temporal{rect} at 6 heads of 40: {errs}, lse {lse_err}")
    return rows


def main_path_products() -> list:
    """Every distinct product (M, N, K and epilogue) kernels 5 and 7 launch
    on the main path: B·F = 16 and 32 at the levels the fused route takes
    (64x64 and 32x32; the 16x16 and 8x8 levels, at 1280 channels, are not
    fused), in the order the modules launch them; the SparseCtrl controlnet,
    the UNet's down and mid half at B·F = 16 and 32, adds none."""
    from motionclone_tpu_torch.ops import fused_block as fb
    from motionclone_tpu_torch.ops import fused_temporal as ft

    seen, out = set(), []
    for hw, c in FUSED_SHAPES:
        for b in (1, 2):
            # the controlnet's motion modules (one attention block) launch a
            # subset of the UNet's (two blocks): no shape of their own
            for p in (fb.products(b * FRAMES, hw * hw, c, b, TEXT_TOKENS, 768)
                      + ft.products(b, FRAMES, hw * hw, c)
                      + ft.products(b, FRAMES, hw * hw, c, n_attn=1)):
                key = p[1:]
                if key not in seen:
                    seen.add(key)
                    out.append(p)
    return out


def check_products(dev) -> None:
    """The product of kernels 5-7 alone (phase 2): each shape against its
    plain version, two launches bit for bit, timed beside torch.matmul."""
    from motionclone_tpu_torch.ops import build as kb
    from motionclone_tpu_torch.ops import fused_common as fc

    gen = torch.Generator(device=dev).manual_seed(7)
    lib = kb.load_library()
    f32, bf16 = torch.float32, torch.bfloat16
    dt = {"bf16": bf16, "f32": f32}
    probe = fc.Product("probe", 64, 160, 64)
    for p in [probe] + main_path_products():
        a = torch.randn(p.m, p.k, generator=gen, device=dev).to(bf16)
        w = (torch.randn(p.n, p.k, generator=gen, device=dev) * p.k ** -0.5).to(bf16)
        bias = 0.1 * torch.randn(p.n, generator=gen, device=dev) if p.bias else None
        res = (torch.randn(p.m, p.n, generator=gen, device=dev).to(dt[p.res])
               if p.res else None)
        kw = dict(geglu_out=p.geglu, out_dtype=dt[p.out], split=p.split)

        def launch(r):
            # the in-place update writes the residual it reads
            return fc.fused_product(a, w, bias, r, out=r if p.inplace else None, **kw)

        first = launch(None if res is None else res.clone())
        again = launch(None if res is None else res.clone())
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"product {p}: two launches differ")
        ref = fc.product_plain(a, w, bias, res, **kw)
        err, tol = max_err((first,), (ref,))
        del again, ref
        # timed through its C entry point: no Python checks per launch
        work = None if res is None else res.clone()
        out = torch.empty_like(first)
        ptrs, dims = fc.product_pointers(a, w, bias, work if p.inplace else res,
                                         work if p.inplace else out,
                                         geglu_out=p.geglu, split=p.split)
        stream = fc.stream_of(a)

        def entry(fn):
            return lambda: kb.check(fn(ptrs, dims, stream), "product")

        ms = time_ms(entry(lib.mc_fused_product), reps=10)
        wt = w.t()
        lib_ms = time_ms(lambda: torch.matmul(a, wt), reps=10)
        flops = 2 * p.m * p.n * p.k
        n_out = p.n // 2 if p.geglu else p.n
        nbytes = (2 * p.m * p.k + 2 * p.n * p.k + (4 * p.n if p.bias else 0)
                  + (res.element_size() * p.m * p.n if p.res else 0)
                  + first.element_size() * p.m * n_out)
        b_ms, b_by = bound(flops, nbytes)
        tf = lambda t: flops / t / 1e9
        epi = ("bias " if p.bias else "") + (f"res {p.res} " if p.res else "") \
            + ("in place " if p.inplace else "") + ("GEGLU " if p.geglu else "") \
            + (f"split {p.split} " if p.split else "") + f"out {p.out}"
        ok = err <= tol
        log(f"product {p.label:10s} (M, N, K)=({p.m}, {p.n}, {p.k}) [{epi}] "
            f"max_abs_err={err:.3e} tol={tol:.3e} {'OK' if ok else 'FAIL'} bits_equal "
            f"kernel_ms={ms:.4f} ({tf(ms):.1f} TFLOP/s) "
            f"library_ms={lib_ms:.4f} ({tf(lib_ms):.1f}) bound_ms={b_ms:.4f} ({b_by})")
        if not ok:
            raise AssertionError(f"product {p}: error {err} > tolerance {tol}")
        del a, w, bias, res, first, work, out, ptrs
        torch.cuda.empty_cache()


def main_path_convs() -> list:
    """Every distinct convolution (M, Cout, 9·Cin and epilogue) kernel 8
    launches on the main path, as ((B·F, H, W, Cin), Product): conv1 (f32
    out, + bias + temb row) and conv2 (bf16 out, + bias + the bf16 input or
    the f32 shortcut) of each resnet the fused route takes, B·F = 16 and
    32."""
    from motionclone_tpu_torch.ops import fused_resnet as fr

    seen, out = set(), []
    for hw, cin, cout in RESNET_SHAPES:
        for b in (1, 2):
            for p in fr.products(b * FRAMES, hw, hw, cin, cout):
                if p.label == "shortcut":
                    continue
                key = (hw,) + p[1:]
                if key not in seen:
                    seen.add(key)
                    out.append(((b * FRAMES, hw, hw, p.k // 9), p))
    return out


def check_convs(dev) -> None:
    """Kernel 8's convolution alone (phase 2): each shape against its plain
    version, two launches bit for bit, timed beside cuDNN's convolution
    (torch.nn.functional.conv2d, channels last, bf16, with its bias) on the
    same operands."""
    from torch.nn import functional as F

    from motionclone_tpu_torch.ops import build as kb
    from motionclone_tpu_torch.ops import fused_common as fc
    from motionclone_tpu_torch.ops import fused_resnet as fr

    gen = torch.Generator(device=dev).manual_seed(11)
    lib = kb.load_library()
    f32, bf16 = torch.float32, torch.bfloat16
    for (bf, h, w, cin), p in main_path_convs():
        act = torch.randn(bf, h, w, cin, generator=gen, device=dev).to(bf16)
        wt = (torch.randn(p.n, 3, 3, cin, generator=gen, device=dev)
              * (9 * cin) ** -0.5).to(bf16)
        wk = wt.reshape(p.n, 9 * cin)
        bias = 0.1 * torch.randn(p.n, generator=gen, device=dev)
        temb = res = None
        if p.res is None:
            temb = torch.randn(bf // FRAMES, p.n, generator=gen, device=dev).to(bf16)
        else:
            res = torch.randn(bf, h, w, p.n, generator=gen, device=dev).to(
                f32 if p.res == "f32" else bf16)
        out_dtype = f32 if p.out == "f32" else bf16
        kw = dict(frames=FRAMES, out_dtype=out_dtype)
        first = fr.conv3x3(act, wk, bias, temb, res, **kw)
        again = fr.conv3x3(act, wk, bias, temb, res, **kw)
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"conv3x3 {p}: two launches differ")
        ref = fr.conv3x3_plain(act, wk, bias, temb, res, **kw)
        err, tol = max_err((first,), (ref,))
        del again, ref
        # timed through its C entry point: no Python checks per launch
        ptrs = kb.pointers(act, wk, bias, temb, res, first)
        dims = kb.ints(bf, FRAMES, h, w, cin, p.n, int(p.res == "f32"), int(p.out == "f32"))
        stream = fc.stream_of(act)
        ms = time_ms(lambda: kb.check(lib.mc_conv3x3(ptrs, dims, stream), "conv3x3"), reps=10)
        x_cl = act.permute(0, 3, 1, 2)  # NCHW view of the channels-last video
        w_cl = wt.permute(0, 3, 1, 2)
        b16 = bias.to(bf16)
        lib_ms = time_ms(lambda: F.conv2d(x_cl, w_cl, b16, padding=1), reps=10)
        flops = 2 * p.m * p.n * p.k
        nbytes = (2 * p.m * cin + 2 * p.n * p.k + 4 * p.n
                  + (0 if temb is None else 2 * temb.numel())
                  + (0 if res is None else res.element_size() * res.numel())
                  + first.element_size() * first.numel())
        b_ms, b_by = bound(flops, nbytes)
        tf = lambda t: flops / t / 1e9
        epi = "bias " + ("temb " if temb is not None else f"res {p.res} ") + f"out {p.out}"
        ok = err <= tol
        log(f"conv {p.label} (M, N, K)=({p.m}, {p.n}, {p.k}) frame {h}x{w} [{epi}] "
            f"max_abs_err={err:.3e} tol={tol:.3e} {'OK' if ok else 'FAIL'} bits_equal "
            f"kernel_ms={ms:.4f} ({tf(ms):.1f} TFLOP/s) cudnn_ms={lib_ms:.4f} "
            f"({tf(lib_ms):.1f}) bound_ms={b_ms:.4f} ({b_by})")
        if not ok:
            raise AssertionError(f"conv3x3 {p}: error {err} > tolerance {tol}")
        del act, wt, wk, bias, temb, res, first, ptrs, x_cl, w_cl, b16
        torch.cuda.empty_cache()


def module_on_card(ctor, dev, gen):
    """A port module with seeded random weights (init_scaled_), bf16 on the
    card, in eval mode."""
    with torch.device("meta"):
        m = ctor()
    m.to_empty(device=dev)
    init_scaled_(m, gen)
    return m.to(torch.bfloat16).eval()


def check_fused(rows, name, shape, kernel, plain, slices, unfused, flops, nbytes, main,
                same_bits=False) -> None:
    """One fused kernel at one shape against its plain version, timed
    beside the port's unfused module; ``plain(sl)`` is the plain version on
    batch slice ``sl`` (the plain time is the sum over the slices).  With
    ``same_bits`` two launches must give the same bits.  ``main`` puts the
    shape in ``rows`` (the kernels JSON line) if the kernel has none yet."""
    out = kernel()
    if same_bits:
        again = kernel()
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"{name} at {shape}: two launches differ")
        del again
    torch.cuda.synchronize()
    got, ref = [], []
    for sl in slices:
        ref.append(plain(sl))
        got.append(out[sl])
    err, tol = max_err(got, ref)
    del got, ref, out
    ms = time_ms(kernel, reps=5, warmup=1)
    plain_ms = sum(time_ms(lambda: plain(sl), reps=2, warmup=1) for sl in slices)
    unfused_ms = time_ms(unfused, reps=5, warmup=1)
    b_ms, b_by = bound(flops, nbytes)
    log(f"kernel {name:25s} shape={shape} max_abs_err={err:.3e} tol={tol:.3e} "
        f"{'OK' if err <= tol else 'FAIL'}{' bits_equal' if same_bits else ''} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}) unfused_ms={unfused_ms:.4f} library_ms=null")
    if err > tol:
        raise AssertionError(f"{name} at {shape}: error {err} > tolerance {tol}")
    if main and name not in rows:
        rows[name] = dict(shape=list(shape), max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=None, unfused_ms=unfused_ms)
    torch.cuda.empty_cache()


def check_fused_kernels(dev) -> dict:
    """Kernels 5-7 at every main-path shape, over the whole batch, against
    their plain versions on the same bf16 inputs and weights (the module's
    own weights in the kernel's layout), timed beside the port's unfused
    module on the same input."""
    from motionclone_tpu_torch.config import MotionModuleConfig
    from motionclone_tpu_torch.models.attention import Transformer3DModel
    from motionclone_tpu_torch.models.motion_module import TemporalTransformer3D
    from motionclone_tpu_torch.ops import fused_block as fb
    from motionclone_tpu_torch.ops import fused_temporal as ft

    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    rows = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    def run(*args, **kwargs):
        check_fused(rows, *args, **kwargs)

    def frame_slices(bf, s):
        # slices of 4 frames bound the plain attention's (4, 8, S, S) f32
        # logits at S = 4096 (2.1 GB)
        n = 4 if s == 4096 else FRAMES
        return [slice(i, i + n) for i in range(0, bf, n)]

    with torch.no_grad():
        for hw, c in FUSED_SHAPES:
            s, d = hw * hw, c // HEADS
            m = module_on_card(lambda: Transformer3DModel(c, HEADS, d), dev, gen)
            blk = m.transformer_blocks[0]
            wt, wb = m.fused_weights(bf16), blk.fused_weights(bf16)
            for b in (1, 2, 4):
                bf = b * FRAMES
                x, ctx = randn(bf, s, c), randn(b, 77, 768)
                x5 = x.view(b, FRAMES, hw, hw, c)
                slices = frame_slices(bf, s)

                def ctx_of(sl):  # the text of the videos the slice's frames belong to
                    return ctx[sl.start // FRAMES: (sl.stop - 1) // FRAMES + 1]

                def frames_of(sl):
                    return min(FRAMES, sl.stop - sl.start)

                mm = 2 * bf * s * c * c  # flops of one C x C product over all rows
                attn = 4 * bf * s * s * c + 4 * bf * s * 77 * c + 4 * b * 77 * 768 * c
                wbytes = 2 * (20 * c * c + 2 * 768 * c)
                run("fused_spatial_transformer", (bf, s, c),
                    lambda: fb.fused_spatial_transformer_kernel(
                        x, ctx, wt, heads=HEADS, groups=32, frames=FRAMES),
                    lambda sl: fb.fused_spatial_transformer_plain(
                        x[sl], ctx_of(sl), wt, heads=HEADS, groups=32, frames=frames_of(sl)),
                    slices, lambda: m(x5, ctx, "flash"),
                    20 * mm + attn, 2 * 2 * bf * s * c + 2 * b * 77 * 768 + wbytes, True)
                if b == 4:  # the sweep's pair: kernel 5 only
                    del x, x5, ctx
                    continue
                # the block alone (kernel 6): off the SD1.5 path, checked at
                # the same shapes
                ctx_f = ctx.repeat_interleave(FRAMES, dim=0)
                run("fused_transformer_block", (bf, s, c),
                    lambda: fb.fused_transformer_block_kernel(
                        x, ctx, wb, heads=HEADS, frames=FRAMES),
                    lambda sl: fb.fused_transformer_block_plain(
                        x[sl], ctx_of(sl), wb, heads=HEADS, frames=frames_of(sl)),
                    slices, lambda: blk(x, ctx_f),
                    18 * mm + attn, 2 * 2 * bf * s * c + 2 * b * 77 * 768 + wbytes,
                    True)
                del x, x5, ctx, ctx_f

            mc = module_on_card(lambda: TemporalTransformer3D(c, MotionModuleConfig()),
                                dev, gen)
            for b in (1, 2, 4):
                x = randn(b, FRAMES, s, c)
                x5 = x.view(b, FRAMES, hw, hw, c)
                wm = mc.fused_weights(x5)
                m_rows = b * FRAMES * s
                run("fused_temporal_module", (b, FRAMES, s, c),
                    lambda: ft.fused_temporal_kernel(x, wm, heads=HEADS, groups=32),
                    lambda sl: ft.fused_temporal_module_plain(
                        x[sl], wm, heads=HEADS, groups=32),
                    [slice(0, b)], lambda: mc(x5),
                    44 * m_rows * c * c + 2 * 4 * b * s * FRAMES * FRAMES * c,
                    2 * 2 * m_rows * c + 2 * 22 * c * c, True)
                del x, x5
    return rows


# (H = W, C) of the controlnet's motion modules at 512x512: kernel 7 with one
# attention block takes the first two on the main path (fused_temporal.
# supported: C <= 640); neither the routing nor the kernel's own shape rule
# takes the other two (C = 1280), which run unfused
CONTROLNET_TEMPORAL_SHAPES = ((64, 320), (32, 640), (16, 1280), (8, 1280))


def check_controlnet_temporal(dev) -> None:
    """Kernel 7 with one attention block and a 32-row positional table (the
    SparseCtrl controlnet's motion modules) at the controlnet's four (S, C)
    at B = 1 (extraction) and 2 (the CFG pair), F = 16, against its plain
    version over the whole batch, two launches bit for bit, timed beside
    the port's unfused module on the same input."""
    from motionclone_tpu_torch.config import MotionModuleConfig
    from motionclone_tpu_torch.models.motion_module import TemporalTransformer3D
    from motionclone_tpu_torch.ops import fused_temporal as ft

    gen = torch.Generator(device=dev).manual_seed(6)
    bf16 = torch.bfloat16
    cfg = MotionModuleConfig(attention_block_types=("Temporal_Self",),
                             temporal_position_encoding_max_len=32)
    with torch.no_grad():
        for hw, c in CONTROLNET_TEMPORAL_SHAPES:
            s = hw * hw
            if not (ft.supported(FRAMES, s, c, HEADS) and ft.device_supported(s, c, 1)):
                log(f"kernel fused_temporal_module (1 attention block) at S={s}, C={c}: "
                    f"not a shape the kernel takes (LayerNorm rows of at most "
                    f"{ft.LN_MAX_CHANNELS} channels) nor one the routing fuses "
                    f"(C > {ft.MAX_CHANNELS}): the controlnet runs it unfused")
                continue
            mc = module_on_card(lambda: TemporalTransformer3D(c, cfg), dev, gen)
            for b in (1, 2, 4):
                x = torch.randn(b, FRAMES, s, c, generator=gen, device=dev).to(bf16)
                x5 = x.view(b, FRAMES, hw, hw, c)
                wm = mc.fused_weights(x5)
                assert len(wm.attn) == 1 and wm.pe.shape[0] == 32
                m_rows = b * FRAMES * s
                check_fused(
                    {}, "fused_temporal_module[1 attn]", (b, FRAMES, s, c),
                    lambda: ft.fused_temporal_kernel(x, wm, heads=HEADS, groups=32),
                    lambda sl: ft.fused_temporal_module_plain(x[sl], wm, heads=HEADS,
                                                              groups=32),
                    [slice(0, b)], lambda: mc(x5),
                    36 * m_rows * c * c + 4 * b * s * FRAMES * FRAMES * c,
                    2 * 2 * m_rows * c + 2 * 18 * c * c, False, same_bits=True)
                del x, x5
            del mc
            torch.cuda.empty_cache()


def check_resnet_kernels(dev) -> dict:
    """Kernel 8 at every main-path shape (RESNET_SHAPES at B·F = 16 and 32)
    against its plain version on the same bf16 inputs and the module's own
    weights in the kernel's layout, two launches bit for bit, timed beside
    the port's unfused module on the same input."""
    from motionclone_tpu_torch.models.resnet import ResnetBlock3D
    from motionclone_tpu_torch.ops import fused_resnet as fr

    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    rows = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    with torch.no_grad():
        for hw, cin, cout in RESNET_SHAPES:
            m = module_on_card(lambda: ResnetBlock3D(cin, cout, 1280), dev, gen)
            w = m.fused_weights(bf16)
            for b in (1, 2, 4):
                x, temb = randn(b, FRAMES, hw, hw, cin), randn(b, 1280)
                t = m.time_emb_proj(torch.nn.functional.silu(temb))
                pix = b * FRAMES * hw * hw
                macs = 9 * cin * cout + 9 * cout * cout + (cin * cout if cin != cout else 0)
                check_fused(
                    rows, "fused_resnet_block", (b * FRAMES, hw, hw, cin, cout),
                    lambda: fr.fused_resnet_kernel(x, t, w, groups=32, eps=1e-5),
                    lambda sl: fr.fused_resnet_block_plain(x[sl], t[sl], w, groups=32, eps=1e-5),
                    [slice(0, b)], lambda: m(x, temb, "flash"),
                    2 * pix * macs, 2 * pix * (cin + cout) + 2 * macs + 2 * b * cout,
                    hw == 64 and cin == cout, same_bits=True)
                del x, t, temb
    return rows


def xl_configs():
    """SDXL + AnimateDiff-SDXL's UNet and noise schedule (``XL_CONFIG``,
    the configuration file of the benchmark's SDXL cell)."""
    from motionclone_tpu_torch.config import (MotionModuleConfig, NoiseScheduleConfig,
                                              UNet3DConfig)

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, XL_CONFIG)) as f:
        config = json.load(f)
    tuples = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    unet = UNet3DConfig(**dict(tuples(config["unet"]), motion_module=MotionModuleConfig(
        **tuples(config["unet"]["motion_module"]))))
    return unet, NoiseScheduleConfig.from_dict(config["noise_schedule"])


def check_xl_kernels(dev) -> None:
    """Kernels 3, 4, 6, 7 and 8 at the shapes SDXL's path gives them and
    SD1.5's does not (``XL_BLOCK``, ``XL_TEMPORAL_FUSED``,
    ``XL_RESNET_SHAPES``, ``XL_TEMPORAL_SHAPES``), each against its plain
    version on the same bf16 inputs (tolerance as at SD1.5's shapes), two
    launches bit for bit, timed beside its bound and the port's unfused
    module (kernels 6-8) or PyTorch's attention (kernels 3-4).  Kernel 6
    runs a two-layer transformer block by block, as the fused route does,
    against the plain block twice."""
    from torch.nn import functional as F

    from motionclone_tpu_torch.models.attention import Transformer3DModel
    from motionclone_tpu_torch.models.motion_module import TemporalTransformer3D
    from motionclone_tpu_torch.models.resnet import ResnetBlock3D
    from motionclone_tpu_torch.ops import fused_block as fb
    from motionclone_tpu_torch.ops import fused_resnet as fr
    from motionclone_tpu_torch.ops import fused_temporal as ft
    from motionclone_tpu_torch.ops import temporal_attention as ta

    gen = torch.Generator(device=dev).manual_seed(20)
    bf16 = torch.bfloat16
    rows = {}
    mm_cfg = xl_configs()[0].motion_module

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    with torch.no_grad():
        # kernel 6: both layers of a 640-wide transformer, 4 frames a plain slice
        hw, c, heads, layers, dc = XL_BLOCK
        s = hw * hw
        m = module_on_card(lambda: Transformer3DModel(
            c, heads, c // heads, cross_attention_dim=dc, use_linear_projection=True,
            num_layers=layers), dev, gen)
        blocks = list(m.transformer_blocks)
        ws = [blk.fused_weights(bf16) for blk in blocks]
        for b in (1, 2):
            bf = b * FRAMES
            if m.fused_route((b, FRAMES, hw, hw, c), (b, TEXT_TOKENS, dc), "cuda") \
                    != "transformer_block":
                raise AssertionError(f"kernel 6 does not take SDXL's {(b, hw, c)}")
            x, ctx = randn(bf, s, c), randn(b, TEXT_TOKENS, dc)
            ctx_f = ctx.repeat_interleave(FRAMES, dim=0)

            def kernel():
                h = x
                for w in ws:
                    h = fb.fused_transformer_block_kernel(h, ctx, w, heads=heads,
                                                          frames=FRAMES)
                return h

            def plain(sl):
                h = x[sl]
                for w in ws:
                    h = fb.fused_transformer_block_plain(
                        h, ctx[sl.start // FRAMES: (sl.stop - 1) // FRAMES + 1], w,
                        heads=heads, frames=min(FRAMES, sl.stop - sl.start))
                return h

            def unfused():
                h = x
                for blk in blocks:
                    h = blk(h, ctx_f)
                return h

            mm = 2 * bf * s * c * c
            attn = 4 * bf * s * s * c + 4 * bf * s * TEXT_TOKENS * c + 4 * b * TEXT_TOKENS * dc * c
            check_fused(rows, "fused_transformer_block", (bf, s, c, heads, layers, dc), kernel,
                        plain, [slice(i, i + 4) for i in range(0, bf, 4)], unfused,
                        layers * (18 * mm + attn),
                        layers * (2 * 2 * bf * s * c + 2 * b * TEXT_TOKENS * dc
                                  + 2 * (18 * c * c + 2 * dc * c)), False, same_bits=True)
            del x, ctx, ctx_f

        # kernel 7 at 128x128x320 and 64x64x640
        for hw, c in XL_TEMPORAL_FUSED:
            s = hw * hw
            mc = module_on_card(lambda: TemporalTransformer3D(c, mm_cfg), dev, gen)
            for b in (1, 2):
                x = randn(b, FRAMES, s, c)
                x5 = x.view(b, FRAMES, hw, hw, c)
                wm = mc.fused_weights(x5)
                m_rows = b * FRAMES * s
                check_fused(rows, "fused_temporal_module", (b, FRAMES, s, c),
                            lambda: ft.fused_temporal_kernel(x, wm, heads=HEADS, groups=32),
                            lambda sl: ft.fused_temporal_module_plain(
                                x[sl], wm, heads=HEADS, groups=32),
                            [slice(i, i + 1) for i in range(b)], lambda: mc(x5),
                            44 * m_rows * c * c + 2 * 4 * b * s * FRAMES * FRAMES * c,
                            2 * 2 * m_rows * c + 2 * 22 * c * c, False, same_bits=True)
                del x, x5, wm

        # kernel 8
        for hw, cin, cout in XL_RESNET_SHAPES:
            m = module_on_card(lambda: ResnetBlock3D(cin, cout, 1280), dev, gen)
            w = m.fused_weights(bf16)
            for b in (1, 2):
                if not m.fused_route((b, FRAMES, hw, hw, cin), "cuda"):
                    raise AssertionError(f"kernel 8 does not take SDXL's {(b, hw, cin, cout)}")
                x, temb = randn(b, FRAMES, hw, hw, cin), randn(b, 1280)
                t = m.time_emb_proj(torch.nn.functional.silu(temb))
                pix = b * FRAMES * hw * hw
                macs = 9 * cin * cout + 9 * cout * cout + (cin * cout if cin != cout else 0)
                check_fused(
                    rows, "fused_resnet_block", (b * FRAMES, hw, hw, cin, cout),
                    lambda: fr.fused_resnet_kernel(x, t, w, groups=32, eps=1e-5),
                    lambda sl: fr.fused_resnet_block_plain(x[sl], t[sl], w, groups=32, eps=1e-5),
                    [slice(0, b)], lambda: m(x, temb, "flash"),
                    2 * pix * macs, 2 * pix * (cin + cout) + 2 * macs + 2 * b * cout,
                    False, same_bits=True)
                del x, t, temb

    # kernels 3-4
    record = attention_recorder({})
    f = FRAMES
    for s, d, batches in XL_TEMPORAL_SHAPES:
        hd, scale = HEADS * d, d ** -0.5
        for b in batches:
            q, k, v, dout = (randn(b, f, s, hd) for _ in range(4))
            out, lse = ta.temporal_fwd(q, k, v, HEADS, scale)
            again = ta.temporal_fwd(q, k, v, HEADS, scale)
            torch.cuda.synchronize()
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                raise AssertionError(f"temporal_fwd: two launches differ at {(b, f, s, hd)}")
            ref_out, ref_lse = ta.temporal_attention_plain(q, k, v, HEADS, scale)
            err, tol = max_err((out,), (ref_out,))
            lse_err = (lse - ref_lse).abs().max().item()
            if lse_err > 1e-2:
                raise AssertionError(f"temporal_fwd lse error {lse_err} at {(b, f, s, hd)}")
            del again, ref_out, ref_lse
            q4, k4, v4 = (temporal_view(x, b, f, s, d) for x in (q, k, v))
            # PyTorch's attention only where its batch of (pixel, head)
            # rows fits a grid's second axis (65535)
            lib_ok = b * s * HEADS <= 65535
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            lib_dev = float("nan") if not lib_ok else (
                lib().transpose(1, 2).reshape(b, f, s, hd).float() - out.float()
            ).abs().max().item()
            record("temporal_fwd", (b, f, s, hd), err, tol,
                   time_ms(lambda: ta.temporal_fwd(q, k, v, HEADS, scale), reps=20),
                   time_ms(lambda: ta.temporal_attention_plain(q, k, v, HEADS, scale)),
                   *bound(4 * b * s * HEADS * f * f * d,
                          (4 * b * f * s * hd) * 2 + b * s * HEADS * f * 4),
                   time_ms(lib, reps=20) if lib_ok else None, lib_dev)
            if b == 1:
                grads = ta.temporal_bwd(q, k, v, lse, dout, HEADS, scale)
                again = ta.temporal_bwd(q, k, v, lse, dout, HEADS, scale)
                torch.cuda.synchronize()
                if not all(torch.equal(g, a) for g, a in zip(grads, again)):
                    raise AssertionError(f"temporal_bwd: two launches differ at {(b, f, s, hd)}")
                err, tol = max_err(grads, ta.temporal_attention_bwd_plain(q, k, v, dout, HEADS,
                                                                          scale))
                lib_ms, lib_grads, lib_dev = None, (), float("nan")
                if lib_ok:
                    lib_ms, lib_grads = library_bwd(q4, k4, v4,
                                                    temporal_view(dout, b, f, s, d), scale)
                    lib_dev = max((lg.transpose(1, 2).reshape(b, f, s, hd).float()
                                   - g.float()).abs().max().item()
                                  for lg, g in zip(lib_grads, grads))
                record("temporal_bwd", (b, f, s, hd), err, tol,
                       time_ms(lambda: ta.temporal_bwd(q, k, v, lse, dout, HEADS, scale),
                               reps=20),
                       time_ms(lambda: ta.temporal_attention_bwd_plain(q, k, v, dout, HEADS,
                                                                       scale)),
                       *bound(10 * b * s * HEADS * f * f * d,
                              (7 * b * f * s * hd) * 2 + b * s * HEADS * f * 4),
                       lib_ms, lib_dev)
                del grads, again, lib_grads
            del q, k, v, dout, out, lse, q4, k4, v4
            torch.cuda.empty_cache()


def xl_checked_shapes() -> dict:
    """Kernel name -> the (first, second argument) shapes phase 2 holds it
    at for SDXL's path (kernels 1-4 and 6-8)."""
    c64 = lambda heads: heads * 64
    out = defaultdict(set)
    for b, s, heads in XL_ATTN_SHAPES:
        for name in ("flash_fwd", "flash_bwd"):
            out[name].add(((b, s, c64(heads)), (b, s, c64(heads))))
    for s, d, batches in XL_TEMPORAL_SHAPES:
        for b in batches:
            out["temporal_fwd"].add(((b, FRAMES, s, HEADS * d),) * 2)
        out["temporal_bwd"].add(((1, FRAMES, s, HEADS * d),) * 2)
    hw, c, _, _, dc = XL_BLOCK
    for b in (1, 2):
        out["fused_transformer_block"].add(((b * FRAMES, hw * hw, c), (b, TEXT_TOKENS, dc)))
        for hw_m, c_m in XL_TEMPORAL_FUSED:
            out["fused_temporal_module"].add(((b, FRAMES, hw_m * hw_m, c_m), None))
        for hw_r, cin, cout in XL_RESNET_SHAPES:
            out["fused_resnet_block"].add(((b, FRAMES, hw_r, hw_r, cin), (b, cout)))
    return out


@contextlib.contextmanager
def recorded_calls(wrappers: dict):
    """While open, each call of a kernel entry point of ``wrappers`` (name ->
    function) appends (name, its first and second arguments' shapes) to the
    list it yields; each entry point's ``launches`` counts on as before."""
    calls, patched = [], []
    for name, fn in wrappers.items():
        mod = sys.modules[fn.__module__]

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, *(tuple(a.shape) if isinstance(a, torch.Tensor) else None
                                   for a in args[:2])))
            return _fn(*args, **kwargs)

        wrapper.launches = fn.launches
        setattr(mod, fn.__name__, wrapper)
        patched.append((mod, fn, wrapper))
    try:
        yield calls
    finally:
        for mod, fn, wrapper in patched:
            fn.launches = wrapper.launches
            setattr(mod, fn.__name__, fn)


def xl_path(dev, wrappers) -> None:
    """Phase 3b: SDXL + AnimateDiff-SDXL at 1024x1024x16 with seeded random
    weights (``XL_CONFIG``'s UNet, recompute on), random text conditioning
    (the joined 2048-wide context, the pooled text, the size and crop ids)
    and random video latents: extraction, then 2 guided + 2 vanilla steps
    on the default path.  The launches of every kernel must be
    ``PREDICTED_XL_LAUNCHES``' and every shape a kernel was launched at one
    phase 2 held it at (``xl_checked_shapes``); the latents finite."""
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.pipeline.motionclone import Conditioning, MotionClonePipeline

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2020)
    dtype = torch.bfloat16
    unet_cfg, sched_cfg = xl_configs()
    infer = t2v_config(width=1024, height=1024, motion_guidance_blocks=("up_blocks.0",))
    pipe = MotionClonePipeline(unet_cfg, sched_cfg, infer,
                               build_model(UNet3DConditionModel, unet_cfg, dev, gen, dtype),
                               device=dev, dtype=dtype)
    pooled_dim = (unet_cfg.projection_class_embeddings_input_dim
                  - 6 * unet_cfg.addition_time_embed_dim)

    def text():
        return Conditioning(
            torch.randn(1, TEXT_TOKENS, unet_cfg.cross_attention_dim, generator=gen,
                        device=dev).to(dtype),
            torch.randn(1, pooled_dim, generator=gen, device=dev).to(dtype), pipe.time_ids(1))

    uncond, cond = text(), text()
    latents = torch.randn(1, FRAMES, 128, 128, 4, generator=gen, device=dev).to(dtype)
    torch.cuda.synchronize()
    log(f"SDXL path: UNet {sum(p.numel() for p in pipe.unet.parameters()) / 1e9:.3f} B "
        f"params, set-up {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with recorded_calls(wrappers) as calls:
        rep = pipe.extract_motion_representation(latents, uncond, seed=2)
        n_extract = len(calls)

        def on_step(i, guided):
            torch.cuda.synchronize()
            steps.append((guided, time.perf_counter()))

        start = time.perf_counter()
        out = pipe.sample_latents(uncond, cond, rep, seed=3, on_step=on_step)
        torch.cuda.synchronize()
    if out.shape != latents.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"SDXL path: latents of shape {tuple(out.shape)} or non-finite")
    ends = [start] + [t for _, t in steps]
    log("SDXL path steps (guided, ms): " + ", ".join(
        f"({g}, {1e3 * (b - a):.1f})" for (g, _), a, b in zip(steps, ends, ends[1:]))
        + f"; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    counts = defaultdict(int)
    counts_extract = defaultdict(int)
    for i, (name, *_) in enumerate(calls):
        counts[name] += 1
        counts_extract[name] += i < n_extract
    g = sum(1 for guided, _ in steps if guided)
    v = len(steps) - g
    differ = []
    for name, (ext, per_g, per_v) in PREDICTED_XL_LAUNCHES.items():
        want = ext + g * per_g + v * per_v
        log(f"SDXL launches {name:25s} measured {counts[name]:4d} predicted {want:4d} "
            f"(extraction {counts_extract[name]} / {ext})"
            f"{'' if counts[name] == want and counts_extract[name] == ext else '  DIFFERS'}")
        if counts[name] != want or counts_extract[name] != ext:
            differ.append(name)
    checked = xl_checked_shapes()
    unchecked = sorted({(name, a, b) for name, a, b in calls
                        if name in checked and (a, b) not in checked[name]}, key=str)
    for name, a, b in unchecked:
        log(f"SDXL path: {name} at {a}, {b}: a shape phase 2 does not hold it at")
    if differ or unchecked:
        raise AssertionError(f"SDXL path: launches differ for {differ}; "
                             f"{len(unchecked)} unchecked shapes")
    del pipe, rep, out
    torch.cuda.empty_cache()


def check_group_norm(dev) -> None:
    """The differentiable GroupNorm (+ SiLU) kernels (phase 2) at every
    GROUP_NORM_SHAPES entry: the forward and dx against their plain versions
    in f32 on the same bf16 inputs, two launches of each bit for bit; f32 at
    (32, 4096, 320); the time of each beside its byte bound (x read and the
    output written once; dy too for the backward) and beside the port's
    eager chain (``group_norm_nhwc`` then SiLU, forward without grad and
    forward + backward under autograd) at (32, 4096, 320) and the VAE's
    largest shape."""
    from torch.nn import functional as F

    from motionclone_tpu_torch.models.layers import group_norm_nhwc
    from motionclone_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device=dev).manual_seed(18)
    groups, eps = 32, 1e-5

    def inputs(n, s, c, dtype):
        x = (torch.randn(n, s, c, generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
        dy = torch.randn(n, s, c, generator=gen, device=dev).to(dtype)
        w = 1.0 + 0.3 * torch.randn(c, generator=gen, device=dev)
        b = 0.3 * torch.randn(c, generator=gen, device=dev)
        return x, dy, w, b

    timed = {(2 * FRAMES, 4096, 320, True), max(GROUP_NORM_SHAPES, key=lambda t: t[0] * t[1] * t[2])}
    for n, s, c, silu in GROUP_NORM_SHAPES + ((2 * FRAMES, 4096, 320, "f32"),):
        dtype = torch.float32 if silu == "f32" else torch.bfloat16
        silu = bool(silu)
        x, dy, w, b = inputs(n, s, c, dtype)
        y, stats = gn.group_norm_fwd(x, w, b, groups, eps, silu)
        dx = gn.group_norm_bwd(dy, x, stats, w, b, groups, silu)
        y2, stats2 = gn.group_norm_fwd(x, w, b, groups, eps, silu)
        dx2 = gn.group_norm_bwd(dy, x, stats2, w, b, groups, silu)
        if not (torch.equal(y, y2) and torch.equal(stats, stats2) and torch.equal(dx, dx2)):
            raise AssertionError(f"group_norm at {(n, s, c, silu)}: two launches differ")
        ref, ref_stats = gn.group_norm_plain(x.float(), w, b, groups, eps, silu)
        ref_dx = gn.group_norm_bwd_plain(dy.float(), x.float(), ref_stats, w, b, groups, silu)
        tol = (2e-5, 1e-4) if dtype == torch.float32 else (GN_FWD_RTOL, GN_BWD_TOL)
        # bf16: relative to each output, with a floor of 1e-5 of the largest
        # (an output near 0 is a difference of two f32 terms, the affine's
        # shift); f32: relative to the largest
        floor = (1e-5 if dtype == torch.bfloat16 else 1.0) * ref.abs().max().item()
        fwd_err = ((y.float() - ref).abs() / (ref.abs() + floor)).max().item()
        # the mean relative to the group's std, rstd relative to itself
        stats_err = max(((stats[0] - ref_stats[0]).abs() * ref_stats[1]).max().item(),
                        ((stats[1] - ref_stats[1]).abs() / ref_stats[1]).max().item())
        dx_mag = ref_dx.abs().max().item()
        bwd_err = (dx.float() - ref_dx).abs().max().item() / dx_mag
        ok = fwd_err <= tol[0] and stats_err <= 1e-4 and bwd_err <= tol[1]
        line = (f"group_norm ({n}, {s}, {c}) {'silu' if silu else 'gn  '} "
                f"{'f32 ' if dtype == torch.float32 else 'bf16'}: forward rel err {fwd_err:.2e} "
                f"(tol {tol[0]:.2e}), stats {stats_err:.1e}, dx err {bwd_err:.2e} of "
                f"{dx_mag:.3g} (tol {tol[1]:.2e}), same bits twice")
        if (n, s, c, silu) in timed and dtype == torch.bfloat16:
            nbytes = x.numel() * x.element_size()
            fwd_ms = time_ms(lambda: gn.group_norm_fwd(x, w, b, groups, eps, silu))
            bwd_ms = time_ms(lambda: gn.group_norm_bwd(dy, x, stats, w, b, groups, silu))
            act = F.silu if silu else (lambda t: t)
            with torch.no_grad():
                plain_ms = time_ms(lambda: act(group_norm_nhwc(x, groups, eps, w, b)))
            leaf = x.detach().requires_grad_(True)

            def eager():
                torch.autograd.grad(act(group_norm_nhwc(leaf, groups, eps, w, b)), leaf, dy)

            eager_ms = time_ms(eager)

            def kernels():
                torch.autograd.grad(gn.group_norm(leaf, w, b, groups, eps, silu=silu), leaf, dy)

            pair_ms = time_ms(kernels)
            line += (f"; forward {fwd_ms:.4f} ms (bound {2 * nbytes / PEAK_BYTES * 1e3:.4f}, "
                     f"eager {plain_ms:.4f}), backward {bwd_ms:.4f} ms (bound "
                     f"{3 * nbytes / PEAK_BYTES * 1e3:.4f}); forward + backward through "
                     f"autograd {pair_ms:.4f} ms, eager chain {eager_ms:.4f} ms")
            del leaf
        log(line)
        if not ok:
            raise AssertionError(f"group_norm at {(n, s, c, silu, dtype)}: beyond tolerance")
        del x, dy, y, y2, dx, dx2, ref, ref_dx


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


def build_pipeline(dev, frame_group=None):
    """The main path's pipeline at SD1.5 + AnimateDiff v3 width with seeded
    random weights, its token ids and its reference video: the same tensors
    in every process that builds it (phase 3, and each rank of phase 6)."""
    from motionclone_tpu_torch.config import NoiseScheduleConfig, UNet3DConfig
    from motionclone_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    gen = torch.Generator(device=dev).manual_seed(1234)
    dtype = torch.bfloat16
    unet_cfg = UNet3DConfig()  # SD1.5 + AnimateDiff v3: 320/640/1280/1280, 8 heads
    pipe = MotionClonePipeline(
        unet_cfg, NoiseScheduleConfig(), t2v_config(),
        build_model(UNet3DConditionModel, unet_cfg, dev, gen, dtype),
        vae=build_model(AutoencoderKL, VAEConfig(), dev, gen, dtype),
        text_encoder=build_model(CLIPTextModel, CLIPTextConfig(), dev, gen, dtype),
        device=dev, dtype=dtype, frame_group=frame_group,
    )
    ids = torch.randint(0, 49408, (2, 77), generator=gen, device=dev)
    video = torch.rand(16, 512, 512, 3, generator=gen, device=dev) * 2 - 1
    torch.cuda.synchronize()
    return pipe, ids, video


def drive(pipe, ids, video, wrappers, decode: bool = True) -> dict:
    """Text embeddings, VAE encode, extraction, 2 guided + 2 vanilla steps,
    the gathered latents and (with ``decode``) the VAE decode, through the
    pipeline's entry points, with every launch count set to 0 just before
    and read just after.  Raises unless every output is finite and of its
    shape (the rank's frames where the pipeline is sharded)."""
    cfg, ucfg, group = pipe.infer_cfg, pipe.unet_cfg, pipe.fns.frame_group
    f, lh, lw = cfg.video_length, cfg.height // 8, cfg.width // 8
    f_local = f // (1 if group is None else group.size)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    phases, steps = {}, []

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
    full = timed("gather", lambda: pipe.gather_latents(out))
    frames = timed("vae_decode", lambda: pipe.decode_latents(full)) if decode else None
    launches = {n: w.launches for n, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    lat_shape = (1, f, lh, lw, ucfg.in_channels)
    checks = {
        "text": (emb, (2, 77, ucfg.cross_attention_dim)), "latents": (latents, lat_shape),
        "sample": (out, (1, f_local, lh, lw, ucfg.in_channels)), "gathered": (full, lat_shape),
    }
    if decode:
        checks["frames"] = (frames, (f, cfg.height, cfg.width, 3))
    for name, (x, shape) in checks.items():
        if tuple(x.shape) != shape or not torch.isfinite(x.float()).all():
            raise AssertionError(f"main path {name}: shape {tuple(x.shape)} "
                                 f"(want {shape}) or non-finite values")
    # up_blocks.1: layers_per_block + 1 motion modules (3 x 2 attention blocks on SD1.5)
    n_rep = ((ucfg.layers_per_block + 1) * ucfg.motion_module.num_transformer_block
             * len(ucfg.motion_module.attention_block_types))
    if len(rep) != n_rep:
        raise AssertionError(f"motion representation has {len(rep)} modules, not {n_rep}")
    # up_blocks.1 works at a quarter of the latents' side: 16 x 16 at 512 x 512
    rep_shape = (1, (lh // 4) * (lw // 4), ucfg.motion_module.num_attention_heads, f_local, 1)
    for name, (vals, idx) in rep.items():
        if vals.shape != rep_shape or not torch.isfinite(vals).all() or int(idx.max()) >= f:
            raise AssertionError(f"motion representation {name} malformed")
    return dict(uncond=uncond, cond=cond, rep=rep, out=out, full=full, phases=phases,
                steps=steps, launches=launches, counts_after_extract=counts_after_extract,
                peak_gb=peak_gb)


def first_guided_loss(pipe, run) -> float:
    """The guidance loss of the first guided step from the sampling noise
    (the ranks' partials summed where the pipeline is sharded)."""
    lat = pipe.initial_latents(seed=3)  # the rank's frames where sharded
    t, tp = (int(x) for x in pipe.fns.timesteps[:2])
    _, loss = pipe.fns.guided_step(lat, t, tp, 1.0, run["uncond"], run["cond"], run["rep"])
    return float(loss)


def rounding_control(pipe, ids, video, wrappers, run) -> dict:
    """The unsharded run again with the same math but other bf16 rounding:
    extraction as one half of a batch of 2 (other product shapes), sampling
    on the unfused ("flash") path.  Phase 6 reads the sharded run's
    deviations beside these."""
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    flash = MotionClonePipeline(pipe.unet_cfg, pipe.sched_cfg, pipe.infer_cfg, pipe.unet,
                                vae=pipe.vae, text_encoder=pipe.text_encoder,
                                device=pipe.device, dtype=pipe.dtype, attention_impl="flash")
    ctrl = drive(flash, ids, video, wrappers, decode=False)
    with torch.no_grad():
        lat = pipe.encode_video(video, seed=1).to(pipe.dtype)
    from motionclone_tpu_torch.utils import rng

    # extraction's noise, as extract_motion_representation draws it from seed 2
    noise = rng.draw_normal(lat.shape, 2, rng.EXTRACT_NOISE, pipe.device).to(pipe.dtype)
    two = lambda x: torch.cat([x, x])
    rep2 = pipe.fns.extract(two(lat), two(noise), two(run["uncond"]))
    return dict(latents=ctrl["full"].float().cpu(),
                rep={k: (v[:1].cpu(), i[:1].cpu()) for k, (v, i) in rep2.items()})


def unsharded_reference(pipe, ids, video, wrappers, run) -> dict:
    """What phase 6 holds the sharded run against: the unsharded run's
    launch counts, final latents, motion representation and first guided
    loss, with its bf16 rounding control."""
    return dict(launches=run["launches"], loss=first_guided_loss(pipe, run),
                latents=run["out"].float().cpu(),
                rep={k: (v.cpu(), i.cpu()) for k, (v, i) in run["rep"].items()},
                control=rounding_control(pipe, ids, video, wrappers, run))


def main_path(dev, wrappers, profile_dir=None) -> dict:
    """Phase 3 (and 5 with ``profile_dir``) on the unsharded pipeline.
    Returns the launch counts and the results phase 6 compares with."""
    t0 = time.perf_counter()
    pipe, ids, video = build_pipeline(dev)
    infer = pipe.infer_cfg
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    log(f"main path: UNet {n_params / 1e9:.3f} B params, schedule cut to "
        f"{infer.inference_steps} steps ({infer.guidance_steps} guided), "
        f"set-up {time.perf_counter() - t0:.1f} s")
    run = drive(pipe, ids, video, wrappers)
    launches, counts_after_extract = run["launches"], run["counts_after_extract"]
    for name, n in launches.items():
        if n <= 0 and name not in OFF_MAIN_PATH:
            raise AssertionError(f"kernel {name} was never launched on the main path")

    for name, sec in run["phases"].items():
        log(f"phase {name}: {sec:.3f} s")
    for kind, flag in (("guided", True), ("vanilla", False)):
        ms = [m for g, m in run["steps"] if g == flag]
        log(f"{kind} steps: {len(ms)}, ms per step: " + ", ".join(f"{m:.1f}" for m in ms))
    log(f"peak device memory: {run['peak_gb']:.2f} GB")
    log(f"launches in extraction: {counts_after_extract}")
    log(f"launches on the main path: {launches}")
    g, v = infer.guidance_steps, infer.inference_steps - infer.guidance_steps
    for name, (ext, per_g, per_v) in PREDICTED_LAUNCHES.items():
        want = ext + g * per_g + v * per_v
        log(f"launches {name:25s} measured {launches[name]:4d} predicted {want:4d} "
            f"(extraction {counts_after_extract[name]} / {ext})"
            f"{'' if launches[name] == want else '  DIFFERS'}")
    reference = unsharded_reference(pipe, ids, video, wrappers, run)
    approx_identity(pipe, run)
    uncond, cond, rep = run["uncond"], run["cond"], run["rep"]
    lat = run["out"].to(pipe.dtype)
    steady_steps(pipe, rep, uncond, cond, lat)
    if profile_dir is not None:
        t, tp = (int(x) for x in pipe.fns.timesteps[:2])
        profile_steps(profile_dir, {
            "guided step": lambda: pipe.fns.guided_step(lat, t, tp, 1.0, uncond, cond, rep),
            "vanilla step": lambda: pipe.fns.vanilla_step(lat, t, tp, uncond, cond),
        })
    return reference


def steady_steps(pipe, rep, uncond, cond, lat) -> None:
    """One guided and one vanilla step of the fused (default) and the
    unfused ("flash") path on the main path's pipeline, in turns (fused,
    flash, flash, fused, after one warm-up round of each); ms per step and
    peak memory per path."""
    from motionclone_tpu_torch.config import NoiseScheduleConfig
    from motionclone_tpu_torch.pipeline.motionclone import make_sampling_fns

    from motionclone_tpu_torch.ops import group_norm as gn

    paths = {"fused": pipe.fns,
             "flash": make_sampling_fns(pipe.unet, NoiseScheduleConfig(), pipe.infer_cfg,
                                        attention_impl="flash")}
    t, tp = (int(x) for x in pipe.fns.timesteps[:2])
    res = defaultdict(list)

    def gn_launches():
        return gn.group_norm_fwd.launches, gn.group_norm_bwd.launches

    for name in ("fused", "flash", "fused", "flash", "flash", "fused"):
        fns = paths[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = gn_launches()
        t0 = time.perf_counter()
        fns.guided_step(lat, t, tp, 1.0, uncond, cond, rep)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n1 = gn_launches()
        fns.vanilla_step(lat, t, tp, uncond, cond)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n2 = gn_launches()
        res[name].append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                          torch.cuda.max_memory_allocated() / 1e9,
                          {"guided": tuple(b - a for a, b in zip(n0, n1)),
                           "vanilla": tuple(b - a for a, b in zip(n1, n2))}))
    for name, runs in res.items():
        steady = runs[1:]  # the first round of each path is its warm-up
        counts = steady[-1][3]
        log(f"steady {name:5s} path: guided ms " + ", ".join(f"{r[0]:.1f}" for r in steady)
            + "; vanilla ms " + ", ".join(f"{r[1]:.1f}" for r in steady)
            + f"; peak device memory {max(r[2] for r in steady):.2f} GB")
        for kind, (fwd, bwd) in counts.items():
            want = PREDICTED_GROUP_NORM_LAUNCHES[kind] if name == "fused" else None
            log(f"steady {name:5s} path: GroupNorm kernel launches a {kind} step: forward "
                f"{fwd}, backward {bwd}"
                + ("" if want is None else f" (predicted {want[0]} / {want[1]})"
                   + ("" if (fwd, bwd) == want else "  DIFFERS")))
        if any(r[3] != counts for r in steady) or min(counts["guided"]) <= 0:
            raise AssertionError(f"steady {name} path: the GroupNorm kernels launched "
                                 f"{[r[3] for r in steady]} times a step (a guided step "
                                 f"must launch both, every step alike)")


# ---------------------------------------------------------------------------
# phase 5 (--profile): where a guided and a vanilla step spend the card's time
# ---------------------------------------------------------------------------


def category(name: str) -> str:
    import re

    n = name.lower()
    if "product_kernel" in n and re.search(r"product_kernel<\d, \w+, \w+, true>", n):
        return "fused modules: convolutions, TMA + wgmma (kernel 8)"
    if "product_kernel" in n:
        return "fused modules: products, TMA + wgmma (kernels 5-7, 8's shortcut)"
    if "fz::" in n or "gn_partial" in n or "gn_finalize" in n or "row_stats" in n:
        return "fused modules: norms (port kernels)"
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
            log(f"  {cat:46s} {ms:9.2f} ms {100 * ms / busy:5.1f}%")
        log("  top kernels:")
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
            log(f"    {ms:8.2f} ms  {name[:110]}")
        prof.export_chrome_trace(os.path.join(out_dir, label.replace(" ", "_") + ".json"))


def reference_unet_config():
    """Phase 4's reduced depth: SD1.5's first two levels (320 and 640
    channels, 8 heads), one layer per block."""
    from motionclone_tpu_torch.config import UNet3DConfig

    return UNet3DConfig(
        down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
        up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
        block_out_channels=(320, 640), layers_per_block=1,
    )


def controlnet_config(unet_cfg, flavour: str):
    """The SparseCtrl controlnet of ``flavour`` ("rgb": configs/sparsectrl/
    latent_condition.yaml, "sketch": image_condition.yaml) on the topology
    of ``unet_cfg``."""
    import dataclasses

    from motionclone_tpu_torch.config import load_yaml
    from motionclone_tpu_torch.models.sparse_controlnet import SparseControlNetConfig

    here = os.path.dirname(os.path.abspath(__file__))
    name = {"rgb": "latent_condition.yaml", "sketch": "image_condition.yaml"}[flavour]
    d = load_yaml(os.path.join(here, "configs", "sparsectrl", name))
    cfg = SparseControlNetConfig.from_yaml_dict(d["controlnet_additional_kwargs"], unet_cfg)
    return dataclasses.replace(cfg, down_block_types=unet_cfg.down_block_types)


def reference_check_i2v(dev, wrappers) -> None:
    """The i2v slice on the card (bf16, the default fused path) against the
    port on the CPU (f32, plain, unfused) at phase 4's reduced depth, for
    both flavours: a controlnet with seeded random weights (no zero head) on
    a condition scattered to frames 0 and 8, its residuals on the CFG pair,
    then the conditioned extraction, one guided and one vanilla step."""
    from motionclone_tpu_torch.config import NoiseScheduleConfig
    from motionclone_tpu_torch.models.sparse_controlnet import (
        SparseControlNetModel,
        scatter_condition,
    )
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.pipeline.motionclone import make_sampling_fns

    cfg = reference_unet_config()
    infer = t2v_config(width=128, height=128)
    gen = torch.Generator().manual_seed(98)
    ref = UNet3DConditionModel(cfg)
    init_scaled_(ref, gen)
    card = UNet3DConditionModel(cfg)
    card.load_state_dict(ref.state_dict())
    card = card.to(device=dev, dtype=torch.bfloat16)
    shape = (1, 16, 16, 16, 4)
    lat, noise = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
    uncond, cond = torch.randn(1, 77, 768, generator=gen), torch.randn(1, 77, 768, generator=gen)
    for flavour in ("rgb", "sketch"):
        cn_cfg = controlnet_config(cfg, flavour)
        cn_ref = SparseControlNetModel(cn_cfg)
        init_scaled_(cn_ref, gen)
        cn_card = SparseControlNetModel(cn_cfg)
        cn_card.load_state_dict(cn_ref.state_dict())
        cn_card = cn_card.to(device=dev, dtype=torch.bfloat16).eval()
        side = 16 * cn_cfg.condition_downscale
        frames = torch.rand(1, 2, side, side, cn_cfg.conditioning_channels, generator=gen)
        c, m = scatter_condition(frames, (0, 8), 16)
        results, launches = {}, {}
        for name, unet, cn, d in (("cpu", ref, cn_ref.eval(), "cpu"),
                                  ("card fused", card, cn_card, dev)):
            for w in wrappers.values():
                w.launches = 0
            fns = make_sampling_fns(unet, NoiseScheduleConfig(), infer, controlnet=cn)
            mv = lambda x: x.to(device=d)
            cn_cond = (mv(c), mv(m), 0.9)
            t, tp = (int(x) for x in fns.timesteps[:2])
            impl = "fused" if d != "cpu" else "flash"
            with torch.no_grad():
                down, mid = cn(mv(torch.cat([lat, lat])), t, mv(torch.cat([uncond, cond])),
                               mv(torch.cat([c, c])), mv(torch.cat([m, m])), 0.9, impl=impl)
            rep = fns.extract(mv(lat), mv(noise), mv(uncond), cn_cond)
            guided, loss = fns.guided_step(mv(lat), t, tp, 1.0, mv(uncond), mv(cond), rep,
                                           cn_cond)
            t, tp = int(fns.timesteps[2]), int(fns.timesteps[3])
            vanilla = fns.vanilla_step(mv(lat), t, tp, mv(uncond), mv(cond), cn_cond)
            launches[name] = {n: w.launches for n, w in wrappers.items()}
            results[name] = {
                "residuals": torch.cat([r.flatten() for r in down + (mid,)]),
                "rep_values": torch.cat([v.flatten() for v, _ in rep.values()]),
                "guided_update": guided - mv(lat), "vanilla_update": vanilla - mv(lat),
                "loss": loss.reshape(1),
            }
        log(f"reference i2v {flavour} launches, card fused path: {launches['card fused']}")
        for name in ("fused_spatial_transformer", "fused_temporal_module",
                     "fused_resnet_block"):
            if launches["card fused"][name] <= 0:
                raise AssertionError(f"reference i2v {flavour}: {name} never launched")
        if not results["cpu"]["residuals"].abs().max() > 0:
            raise AssertionError(f"reference i2v {flavour}: the residuals are zero")
        # phase 4's tolerances; the residuals pass through the controlnet's
        # depth once, as the noise prediction through the UNet's
        tols = {"residuals": 3e-2, "rep_values": 3e-2, "guided_update": 1e-1,
                "vanilla_update": 1e-1, "loss": 1e-1}
        for key, tol in tols.items():
            a = results["cpu"][key].float()
            b = results["card fused"][key].float().cpu()
            rel = ((a - b).norm() / a.norm()).item()
            ok = bool(torch.isfinite(b).all()) and rel <= tol
            log(f"reference i2v {flavour} card fused {key}: relative L2 error {rel:.3e} "
                f"(tol {tol:.0e}) {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"reference i2v check {flavour} {key}: {rel}")
        del cn_card, cn_ref
    torch.cuda.empty_cache()


def reference_check(dev, wrappers) -> None:
    """The port on the card (bf16, kernels) against the port on the CPU
    (f32, plain versions, unfused) at a reduced depth that keeps the card's
    kernel shapes: SD1.5 channels 320/640, 8 heads (head dims 40/80), 16
    frames, 16x16 latents; one guided and one vanilla step and plain
    sampling (``sample_plain``, 4 steps) from the same inputs, on the
    card's default (fused) path and on its "flash" path.
    Then one linear-projection Transformer3DModel (320 channels, 8 heads),
    whose block takes kernel 6 on the fused path."""
    from motionclone_tpu_torch.config import NoiseScheduleConfig
    from motionclone_tpu_torch.models.attention import Transformer3DModel
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.pipeline.motionclone import make_sampling_fns, resolve_impl

    cfg = reference_unet_config()
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
    results, launches = {}, {}
    for name, unet, d, impl in (("cpu", ref, "cpu", "auto"), ("card fused", card, dev, "auto"),
                                ("card flash", card, dev, "flash")):
        # inputs and the DDIM step math stay f32 on both sides; only the
        # card's UNet computes in bf16
        for w in wrappers.values():
            w.launches = 0
        fns = make_sampling_fns(unet, NoiseScheduleConfig(), infer, attention_impl=impl)
        mv = lambda x: x.to(device=d)
        rep = fns.extract(mv(lat), mv(noise), mv(uncond))
        t, tp = (int(x) for x in fns.timesteps[:2])
        guided, loss = fns.guided_step(mv(lat), t, tp, 1.0, mv(uncond), mv(cond), rep)
        t, tp = int(fns.timesteps[2]), int(fns.timesteps[3])
        vanilla = fns.vanilla_step(mv(lat), t, tp, mv(uncond), mv(cond))
        with torch.no_grad():
            pred, _ = unet(mv(lat), t, mv(cond),
                           attention_impl=resolve_impl(impl, torch.device(d)))
        plain = fns.sample_plain(mv(lat), mv(uncond), mv(cond))
        launches[name] = {n: w.launches for n, w in wrappers.items()}
        results[name] = {
            "rep_values": torch.cat([v.flatten() for v, _ in rep.values()]),
            "noise_pred": pred,
            "guided_update": guided - mv(lat), "vanilla_update": vanilla - mv(lat),
            "plain_update": plain - mv(lat), "loss": loss.reshape(1),
        }
    log(f"reference launches, card fused path: {launches['card fused']}")
    for name in ("fused_spatial_transformer", "fused_temporal_module", "fused_resnet_block"):
        if launches["card fused"][name] <= 0 or launches["card flash"][name]:
            raise AssertionError(f"reference: {name} launched {launches['card fused'][name]} "
                                 f"times on the fused path, {launches['card flash'][name]} "
                                 f"on the flash path")
    # bf16 weights and activations through the whole depth against f32: a
    # few 1e-3 of relative error per layer, compounded.  The steps' updates
    # carry CFG, cond + 7.5 * (cond - uncond), which multiplies the error of
    # the small cond - uncond difference by 8.5, and the guidance gradient.
    # The fused path rounds to bf16 where the unfused one does, so both
    # paths are held to the same tolerances; plain sampling (4 "leading"
    # vanilla steps) to the vanilla step's.
    tols = {"rep_values": 3e-2, "noise_pred": 3e-2, "guided_update": 1e-1,
            "vanilla_update": 1e-1, "plain_update": 1e-1, "loss": 1e-1}
    for path in ("card fused", "card flash"):
        for key, tol in tols.items():
            a = results["cpu"][key].float()
            b = results[path][key].float().cpu()
            rel = ((a - b).norm() / a.norm()).item()
            ok = rel <= tol
            log(f"reference {path} {key}: relative L2 error {rel:.3e} (tol {tol:.0e}) "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"reference check {path} {key}: {rel}")

    # kernel 6: the linear-projection model's block on the card
    m_cpu = Transformer3DModel(320, HEADS, 320 // HEADS, use_linear_projection=True)
    init_scaled_(m_cpu, gen)
    m_card = Transformer3DModel(320, HEADS, 320 // HEADS, use_linear_projection=True)
    m_card.load_state_dict(m_cpu.state_dict())
    m_card = m_card.to(device=dev, dtype=torch.bfloat16).eval()
    x, ctx = torch.randn(1, 16, 16, 16, 320, generator=gen), torch.randn(1, 77, 768, generator=gen)
    before = wrappers["fused_transformer_block"].launches
    with torch.no_grad():
        want = m_cpu.eval()(x, ctx)
        got = m_card(x.to(dev, torch.bfloat16), ctx.to(dev, torch.bfloat16), "fused")
    n = wrappers["fused_transformer_block"].launches - before
    rel = ((want - got.float().cpu()).norm() / want.norm()).item()
    # one bf16 module against f32: a few 1e-3
    log(f"reference linear-projection transformer (kernel 6, {n} launch): "
        f"relative L2 error {rel:.3e} (tol 2e-02) {'OK' if rel <= 2e-2 else 'FAIL'}")
    if n != 1 or rel > 2e-2:
        raise AssertionError(f"reference kernel 6: {n} launches, error {rel}")


# ---------------------------------------------------------------------------
# phase 6: the frame-sharded main path, two ranks on the one card
# ---------------------------------------------------------------------------


def shard_rank(group, build=build_pipeline, device=None) -> dict:
    """One rank of phase 6 on its device (the current CUDA device unless
    given): the main path's pipeline sharded over the frame group, driven as
    phase 3 drives it (the VAE decode on rank 0 only), then the first
    guided step's loss.  Returns the counts, times and gathered results;
    raises on a malformed output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    pipe, ids, video = build(dev, group)
    setup_s = time.perf_counter() - t0
    run = drive(pipe, ids, video, wrappers, decode=group.rank == 0)
    loss = first_guided_loss(pipe, run)
    rep = {k: (group.gather_frames(v, dim=3).cpu(), group.gather_frames(i, dim=3).cpu())
           for k, (v, i) in run["rep"].items()}
    return dict(rank=group.rank, setup_s=setup_s, phases=run["phases"], steps=run["steps"],
                peak_gb=run["peak_gb"], launches=run["launches"],
                counts_after_extract=run["counts_after_extract"],
                latents=run["full"].float().cpu(), rep=rep, loss=loss)


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def sharded_path(dev, reference, shards: int, backend: str,
                 build=build_pipeline) -> dict:
    """Phase 6: the main path sharded over ``shards`` frame shards, each
    rank a process of its own: under gloo all on the one card, under nccl
    one card each.  Held to the launch prediction and against the unsharded
    run from the same seeds.  Returns rank 0's launch counts."""
    from motionclone_tpu_torch.parallel.frames import launch

    if backend == "gloo":
        devices, where = [str(dev)] * shards, f"{shards} ranks sharing one card"
        log(f"sharded path: {shards} frame shards, backend gloo: {where} "
            f"({torch.cuda.get_device_name(dev)}), every gather staged through host memory")
    else:
        devices, where = [f"cuda:{r}" for r in range(shards)], "one card per rank"
        log(f"sharded path: {shards} frame shards, backend {backend}: {where}")
    t0 = time.perf_counter()
    results = launch(shard_rank, shards, backend=backend, devices=devices, args=(build,),
                     timeout=600.0)
    log(f"sharded path: {shards} ranks done in {time.perf_counter() - t0:.1f} s")
    check_ranks(results, where)
    check_agreement(results[0], reference)
    return results[0]["launches"]


def check_ranks(results, where: str) -> None:
    """Each rank's times (on ``where`` it ran) and memory; raises unless
    every rank launched the predicted counts (3r and 4r at least once) and
    gathered the same latents."""
    infer = t2v_config()
    g, v = infer.guidance_steps, infer.inference_steps - infer.guidance_steps
    faults = []
    for res in results:
        r = res["rank"]
        log(f"rank {r}: set-up {res['setup_s']:.1f} s; "
            + ", ".join(f"{k} {sec:.3f} s" for k, sec in res["phases"].items()))
        for kind, flag in (("guided", True), ("vanilla", False)):
            ms = [m for gd, m in res["steps"] if gd == flag]
            log(f"rank {r} {kind} steps ({where}): ms per step "
                + ", ".join(f"{m:.1f}" for m in ms))
        log(f"rank {r} peak device memory: {res['peak_gb']:.2f} GB")
        for name, (ext, per_g, per_v) in PREDICTED_SHARDED_LAUNCHES.items():
            want, got = ext + g * per_g + v * per_v, res["launches"][name]
            log(f"rank {r} launches {name:25s} measured {got:4d} predicted {want:4d} "
                f"(extraction {res['counts_after_extract'][name]} / {ext})"
                f"{'' if got == want else '  DIFFERS'}")
            if got != want:
                faults.append(f"rank {r} {name}: {got} launches, predicted {want}")
        for name in ("temporal_fwd_rect", "temporal_bwd_rect"):
            if res["launches"][name] < 1:
                faults.append(f"rank {r} never launched {name}")
        if not torch.equal(res["latents"], results[0]["latents"]):
            faults.append(f"rank {r} gathered other latents than rank 0")
    if faults:
        raise AssertionError("sharded path: " + "; ".join(faults))


def deviations(got, reference) -> dict:
    names = sorted(reference["rep"])
    vals = lambda rep: torch.cat([rep[k][0].flatten() for k in names])
    idx = lambda rep: torch.cat([rep[k][1].flatten() for k in names])
    return {
        "latents_rel_l2": rel_l2(got["latents"], reference["latents"]),
        "rep_values_rel_l2": rel_l2(vals(got["rep"]), vals(reference["rep"])),
        "rep_indices_equal_share":
            (idx(got["rep"]) == idx(reference["rep"])).float().mean().item(),
    }


def check_agreement(got, reference) -> None:
    """A rank's gathered latents, motion representation and summed loss
    against the unsharded run's, within SHARD_TOLS; beside each, the same
    deviation of the unsharded rounding control (no tolerance)."""
    metrics = deviations(got, reference)
    metrics["loss_rel"] = abs(got["loss"] - reference["loss"]) / abs(reference["loss"])
    control = deviations(reference["control"], reference)
    log(f"sharded vs unsharded loss of the first guided step: summed partials "
        f"{got['loss']!r}, unsharded {reference['loss']!r}")
    for key, val in metrics.items():
        tol = SHARD_TOLS[key]
        share = key == "rep_indices_equal_share"
        ok = val >= tol if share else val <= tol
        ctrl = f"; bf16 rounding control {control[key]:.4e}" if key in control else ""
        log(f"sharded vs unsharded {key}: {val:.4e} ({'min' if share else 'tol'} "
            f"{tol:g}) {'OK' if ok else 'FAIL'}{ctrl}")
        if not ok:
            raise AssertionError(f"sharded path {key}: {val} against {tol}")


# ---------------------------------------------------------------------------
# phase 7: the t2v CLI at SD1.5 width, from a model directory on disk
# ---------------------------------------------------------------------------

# the fused path's kernels, each of which the CLI run must launch: 1, 2, 3,
# 4, 5, 7 and 8 (6 is the linear-projection models', 3r/4r the sharded path's)
CLI_KERNELS = ("flash_fwd", "flash_bwd", "temporal_fwd", "temporal_bwd",
               "fused_spatial_transformer", "fused_temporal_module", "fused_resnet_block")


def diffusers_configs(unet_cfg, vae_cfg, clip_cfg) -> dict:
    """The config.json of each subfolder, in diffusers' and transformers'
    field names, for the given topologies (2D block classes, as a
    Stable Diffusion checkpoint names them)."""
    to_2d = lambda names: [n.replace("3D", "2D") for n in names]
    return {
        "unet": {"_class_name": "UNet2DConditionModel", "in_channels": unet_cfg.in_channels,
                 "out_channels": unet_cfg.out_channels,
                 "flip_sin_to_cos": unet_cfg.flip_sin_to_cos, "freq_shift": unet_cfg.freq_shift,
                 "down_block_types": to_2d(unet_cfg.down_block_types),
                 "up_block_types": to_2d(unet_cfg.up_block_types),
                 "block_out_channels": list(unet_cfg.block_out_channels),
                 "layers_per_block": unet_cfg.layers_per_block,
                 "norm_num_groups": unet_cfg.norm_num_groups,
                 "cross_attention_dim": unet_cfg.cross_attention_dim,
                 "attention_head_dim": unet_cfg.attention_head_dim},
        "vae": {"_class_name": "AutoencoderKL", "in_channels": vae_cfg.in_channels,
                "out_channels": vae_cfg.out_channels, "latent_channels": vae_cfg.latent_channels,
                "block_out_channels": list(vae_cfg.block_out_channels),
                "layers_per_block": vae_cfg.layers_per_block,
                "norm_num_groups": vae_cfg.norm_num_groups,
                "scaling_factor": vae_cfg.scaling_factor},
        "text_encoder": {"architectures": ["CLIPTextModel"], "vocab_size": clip_cfg.vocab_size,
                         "hidden_size": clip_cfg.hidden_size,
                         "intermediate_size": clip_cfg.intermediate_size,
                         "num_hidden_layers": clip_cfg.num_layers,
                         "num_attention_heads": clip_cfg.num_heads,
                         "max_position_embeddings": clip_cfg.max_position_embeddings,
                         "hidden_act": clip_cfg.hidden_act,
                         "layer_norm_eps": clip_cfg.layer_norm_eps},
    }


def sd15_configs():
    """SD1.5 + AnimateDiff v3: the UNet3D, the SD VAE and CLIP ViT-L/14."""
    from motionclone_tpu_torch.config import UNet3DConfig
    from motionclone_tpu_torch.models.clip_text import CLIPTextConfig
    from motionclone_tpu_torch.models.vae import VAEConfig

    return UNet3DConfig(), VAEConfig(), CLIPTextConfig()


def write_model_dir(root: str, dev, cfgs) -> dict:
    """A model directory for the topologies ``cfgs`` (UNet3D, VAE, CLIP;
    phase 7 takes SD1.5 + AnimateDiff v3's) with seeded random weights (at
    SD1.5 width, phase 3's), saved in bf16 with torch.save: ``sd/unet`` (no
    motion modules), ``mm.ckpt`` (the motion modules, with the
    ``pos_encoder.pe`` buffers real ones carry), ``sd/vae``,
    ``sd/text_encoder`` (Hugging Face keys and the ``position_ids``
    buffer), their config.json files, a byte-level tokenizer (ids inside
    CLIP's 49408), ``model_config.yaml`` (the repo's) and ``t2v.yaml``
    (configs/t2v_camera.yaml with only the asset paths changed).  Returns
    the saved state dicts (CPU, bf16) by module, for the load check."""
    from motionclone_tpu_torch.io.tokenizer import BOS, EOS, bytes_to_unicode
    from motionclone_tpu_torch.models.clip_text import CLIPTextModel
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.models.vae import AutoencoderKL

    gen = torch.Generator(device=dev).manual_seed(1234)  # phase 3's weights
    saved = {}
    for name, cls, cfg in zip(("unet", "vae", "text_encoder"),
                              (UNet3DConditionModel, AutoencoderKL, CLIPTextModel), cfgs):
        model = build_model(cls, cfg, dev, gen, torch.bfloat16)
        saved[name] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        del model
    torch.cuda.empty_cache()
    sd = os.path.join(root, "sd")
    unet = saved["unet"]
    mm = {k: v for k, v in unet.items() if "motion_modules." in k}
    for key, w in list(mm.items()):  # one table per temporal attention
        if key.endswith(".to_q.weight"):
            prefix = key[: -len("to_q.weight")]
            mm[prefix + "pos_encoder.pe"] = torch.zeros(1, 24, w.shape[0], dtype=torch.bfloat16)
    clip = dict(saved["text_encoder"])
    clip["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    configs = diffusers_configs(*cfgs)
    for sub, state, fname in (
            ("unet", {k: v for k, v in unet.items() if "motion_modules." not in k},
             "diffusion_pytorch_model.bin"),
            ("vae", saved["vae"], "diffusion_pytorch_model.bin"),
            ("text_encoder", clip, "pytorch_model.bin")):
        os.makedirs(os.path.join(sd, sub))
        torch.save(state, os.path.join(sd, sub, fname))
        with open(os.path.join(sd, sub, "config.json"), "w") as fh:
            json.dump(configs[sub], fh)
    torch.save(mm, os.path.join(root, "mm.ckpt"))
    os.makedirs(os.path.join(sd, "tokenizer"))
    units = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(units + [u + "</w>" for u in units] + [BOS, EOS])}
    with open(os.path.join(sd, "tokenizer", "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump(vocab, fh, ensure_ascii=False)
    with open(os.path.join(sd, "tokenizer", "merges.txt"), "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "model_config", "model_config.yaml")) as fh:
        model_config = fh.read()
    with open(os.path.join(root, "model_config.yaml"), "w") as fh:
        fh.write(model_config)
    assets = {"motion_module": "mm.ckpt", "dreambooth_path": "", "model_config":
              "model_config.yaml"}
    lines = []
    with open(os.path.join(here, "configs", "t2v_camera.yaml")) as fh:
        for line in fh:
            key = line.split(":", 1)[0]
            lines.append(f'{key}: "{assets[key]}"\n' if key in assets else line)
    with open(os.path.join(root, "t2v.yaml"), "w") as fh:
        fh.writelines(lines)
    return saved


def reference_clip(frames: int, side: int):
    """``frames`` frames of side x side RGB uint8: a seeded noise texture
    that slides 8 pixels right and 4 down per frame (a camera pan)."""
    import numpy as np

    tex = np.random.default_rng(7).integers(0, 256, size=(side + 8 * frames,) * 2 + (3,),
                                            dtype=np.uint8)
    return np.stack([tex[4 * i:4 * i + side, 8 * i:8 * i + side] for i in range(frames)])


def check_loaded(rt, saved: dict) -> None:
    """Every parameter the CLI's runtime loaded equals what was saved, bit
    for bit in bf16."""
    pipe = rt.pipeline
    for name, module in (("unet", pipe.unet), ("vae", pipe.vae),
                         ("text_encoder", pipe.text_encoder)):
        got = module.state_dict()
        if sorted(got) != sorted(saved[name]):
            raise AssertionError(f"t2v CLI: the loaded {name} has other keys than were saved")
        for k, v in saved[name].items():
            g = got[k]
            if g.dtype != torch.bfloat16 or not torch.equal(g.cpu().view(torch.int16),
                                                            v.view(torch.int16)):
                raise AssertionError(f"t2v CLI: loaded {name} {k} differs from what was saved")


def stub_codec(clip) -> dict:
    """Where cv2 is absent: the reference clip and its first frame stand for
    what the CLIs decode, and the videos they write land in the returned
    dict by path (None where cv2 is present)."""
    import importlib.util

    from motionclone_tpu_torch.io import video as video_io
    from motionclone_tpu_torch.pipeline import runner

    if importlib.util.find_spec("cv2") is not None:
        return None
    stubbed = {}
    log("video and image codec: cv2 absent on this machine; decode/write stubbed")
    video_io.read_video_frames = lambda path: (clip, 8.0)
    video_io.read_image_rgb = lambda path: clip[0]
    runner.write_video = lambda path, video, fps=8: stubbed.__setitem__(path, video)
    return stubbed


def read_output(paths, stubbed):
    """The one video a CLI run wrote, as uint8 frames."""
    from motionclone_tpu_torch.io import video as video_io

    return stubbed[paths[0]] if stubbed is not None else video_io.read_video_frames(
        paths[0])[0]


def check_video(tag: str, video, frames: int, side: int) -> None:
    if (video.shape != (frames, side, side, 3) or video.dtype.name != "uint8"
            or int(video.max()) == 0 or int(video.min()) == int(video.max())):
        raise AssertionError(f"{tag} output {video.shape} {video.dtype} is constant, all "
                             f"zero or of another shape")


def run_cli(main, argv, wrappers, on_chunk=None) -> dict:
    """``main(argv)`` with every launch count set to 0 just before and read
    just after; the final latents (CPU, f32) are kept from
    ``MotionClonePipeline.sample_latents``, to which ``on_chunk`` is
    passed.  Returns the runtime, the paths, the launches, the latents,
    the seconds of the call and the peak device memory."""
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    sample, seen = MotionClonePipeline.sample_latents, []

    def spy(self, *args, **kwargs):
        if on_chunk is not None:
            kwargs["on_chunk"] = on_chunk
        out = sample(self, *args, **kwargs)
        seen.append(out.float().cpu())
        return out

    MotionClonePipeline.sample_latents = spy
    try:
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rt, paths = main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {n: wrappers[n].launches for n in CLI_KERNELS}
    finally:
        MotionClonePipeline.sample_latents = sample
    return dict(rt=rt, paths=paths, launches=launches, latents=seen[-1], seconds=seconds,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def t2v_argv(root: str, dev, out: str = "out") -> list:
    side, frames = 512, 16
    return ["--pretrained-model-path", os.path.join(root, "sd"),
            "--inference_config", os.path.join(root, "t2v.yaml"),
            "--examples", os.path.join(root, "examples.jsonl"),
            "--motion-representation-save-dir", os.path.join(root, "reps"),
            "--generated-videos-save-dir", os.path.join(root, out),
            "--config-root", root, "--device", str(dev),
            "--W", str(side), "--H", str(side), "--L", str(frames)]


def t2v_cli(dev, wrappers, card: str, root: str) -> dict:
    """Phase 7: the port's ``cli.t2v_main`` on ``dev``, from a model
    directory written to ``root`` at SD1.5 + AnimateDiff v3 width, on a
    reference clip of 16 frames of 512 x 512; then again, which must reuse
    the cached motion representation.  Returns what phases 8 and 9 build
    on: the saved state dicts, the run's final latents and video."""
    import contextlib
    import io

    from motionclone_tpu_torch import cli
    from motionclone_tpu_torch.diffusion.guidance import load_motion_representation_meta
    from motionclone_tpu_torch.io import video as video_io
    from motionclone_tpu_torch.pipeline import runner

    side, frames = 512, 16
    clip = reference_clip(frames, side)
    stubbed = stub_codec(clip)
    t0 = time.perf_counter()
    saved = write_model_dir(root, dev, sd15_configs())
    write_s = time.perf_counter() - t0
    if stubbed is None:
        video_io.write_video(os.path.join(root, "reference.mp4"), clip, fps=8)
    with open(os.path.join(root, "examples.jsonl"), "w") as fh:
        fh.write(json.dumps({"video_path": "reference.mp4",
                             "new_prompt": "Relics on the seabed", "seed": 42}) + "\n")
    argv = t2v_argv(root, dev)
    run = run_cli(cli.t2v_main, argv, wrappers)
    rt, paths, launches, video_s, peak_gb = (run[k] for k in ("rt", "paths", "launches",
                                                               "seconds", "peak_gb"))
    cfg, timings = rt.infer_cfg, rt.timings
    log(f"t2v CLI: schedule {cfg.inference_steps} steps, {cfg.guidance_steps} guided "
        f"(configs/t2v_camera.yaml's), {side}x{side}x{frames}, bf16, random weights")
    g, v = cfg.guidance_steps, cfg.inference_steps - cfg.guidance_steps
    for name, n in launches.items():
        ext, per_g, per_v = PREDICTED_LAUNCHES[name]
        want = ext + g * per_g + v * per_v
        log(f"t2v CLI launches {name:25s} measured {n:5d} predicted {want:5d}"
            f"{'' if n == want else '  DIFFERS'}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"t2v CLI: kernels never launched: {missing}")
    check_loaded(rt, saved)
    name = "reference_" + (("Relics on the seabed" + cfg.positive_prompt).strip()
                           .replace(" ", "_")) + "42_42.mp4"
    if paths != [os.path.join(root, "out", name)]:
        raise AssertionError(f"t2v CLI wrote {paths}, not {name}")
    out = read_output(paths, stubbed)
    check_video("t2v CLI", out, frames, side)
    rep_path = os.path.join(root, "reps", "reference.npz")
    if load_motion_representation_meta(rep_path) != runner.motion_rep_meta(cfg, 42):
        raise AssertionError("t2v CLI: the motion representation's meta is missing or wrong")
    median = lambda ms: sorted(ms)[len(ms) // 2]
    g, v = timings["guided_ms"], timings["vanilla_ms"]  # ms per step
    for line in (
            f"weights written in {write_s:.1f} s, loaded in {rt.load_seconds:.1f} s",
            f"tokenizer + CLIP {timings['text']:.3f} s",
            f"extraction {timings['extract']:.2f} s",
            f"sampling {timings['sample']:.2f} s: ms per guided step median "
            f"{median(g):.1f} (min {min(g):.1f}, max {max(g):.1f}, {len(g)} steps), "
            f"per vanilla step median {median(v):.1f} (min {min(v):.1f}, "
            f"max {max(v):.1f}, {len(v)} steps)",
            f"decode + write {timings['decode_write']:.2f} s",
            f"peak device memory {peak_gb:.2f} GB",
            f"seconds per video from the CLI: {video_s:.1f} (weights load included), "
            f"{video_s - rt.load_seconds:.1f} (excluded)"):
        log(f"t2v CLI {line} [{card}]")
    result = dict(saved=saved, latents=run["latents"], video=out, seconds=video_s,
                  load_seconds=rt.load_seconds, sample_seconds=timings["sample"],
                  guidance_steps=cfg.guidance_steps)
    del rt, run
    torch.cuda.empty_cache()

    second = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(second):
        cli.t2v_main(argv)
    reuse = [ln for ln in second.getvalue().splitlines() if "motion representation" in ln]
    log(f"t2v CLI second run: {time.perf_counter() - t0:.1f} s; " + "; ".join(reuse))
    if not any("reused from" in ln and rep_path in ln for ln in reuse):
        raise AssertionError("t2v CLI: the second run did not reuse the cached "
                             "motion representation")
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 7b: the assembler's optional merges, loaded onto the card
# ---------------------------------------------------------------------------

# the kohya image LoRA's strength (the assembler's default) and the two
# motion LoRAs' alphas, merged in this order
IMAGE_LORA_ALPHA = 0.8
MOTION_LORA_ALPHAS = (1.0, 0.5)
LDM = "model.diffusion_model."


def ldm_unet_keys(keys, layers: int) -> dict:
    """{diffusers key: LDM key} for the 2D UNet's image layers: the keys of
    a DreamBooth (CompVis) checkpoint that ``weights.ldm.convert_ldm_unet``
    maps back onto ``keys``.  Raises on a key it cannot place."""
    res = {"norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
           "norm2": "out_layers.0", "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}
    flat = {"time_embedding.linear_1": "time_embed.0", "time_embedding.linear_2": "time_embed.2",
            "conv_in": "input_blocks.0.0", "conv_norm_out": "out.0", "conv_out": "out.2"}
    with_attn = {k.split(".")[1] for k in keys if k.startswith("up_blocks.") and ".attentions." in k}
    out = {}
    for k in keys:
        p = k.split(".")
        head, leaf, n = ".".join(p[:-1]), p[-1], layers + 1
        if head in flat:
            name = f"{flat[head]}.{leaf}"
        elif p[0] == "mid_block":
            name = (f"middle_block.{0 if p[2] == '0' else 2}.{res[p[3]]}.{leaf}"
                    if p[1] == "resnets" else f"middle_block.1.{'.'.join(p[3:])}")
        elif p[0] in ("down_blocks", "up_blocks") and p[2] in ("downsamplers", "upsamplers"):
            b = int(p[1])
            name = (f"input_blocks.{(b + 1) * n}.0.op.{leaf}" if p[0] == "down_blocks" else
                    f"output_blocks.{b * n + layers}.{2 if p[1] in with_attn else 1}.conv.{leaf}")
        elif p[0] in ("down_blocks", "up_blocks") and p[2] in ("resnets", "attentions"):
            i = (1 if p[0] == "down_blocks" else 0) + int(p[1]) * n + int(p[3])
            blocks = "input_blocks" if p[0] == "down_blocks" else "output_blocks"
            name = (f"{blocks}.{i}.0.{res[p[4]]}.{leaf}" if p[2] == "resnets"
                    else f"{blocks}.{i}.1.{'.'.join(p[4:])}")
        else:
            raise AssertionError(f"merged weights: no LDM key for {k}")
        out[k] = LDM + name
    return out


def lora_pair(gen, out_ch: int, in_ch: int, rank: int, conv: bool = False) -> tuple:
    """Seeded random float32 (up, down), as write_adapter_lora draws them."""
    tail = (1, 1) if conv else ()
    return (torch.randn((out_ch, rank) + tail, generator=gen) * 0.01,
            torch.randn((rank, in_ch) + tail, generator=gen) * in_ch ** -0.5)


def host_merge(w, merges):
    """The host reference of a merged weight: per (alpha, up, down), in
    order, ``w + alpha * (up @ down)`` in float32 (numpy, as the assembler
    computes it), cast back to ``w``'s dtype; then bf16, as the card holds
    it."""
    for alpha, up, down in merges:
        delta = up.float().numpy().reshape(up.shape[0], -1) @ down.float().numpy().reshape(
            down.shape[0], -1)
        w = torch.from_numpy(w.float().numpy() + alpha * delta.reshape(w.shape)).to(w.dtype)
    return w.to(torch.bfloat16)


def merged_weights(dev, wrappers, card: str, root: str, saved: dict) -> None:
    """Phase 7b: ``weights.load.assemble_state_dicts`` with every optional
    merge on phase 7's model directory (SD1.5 + AnimateDiff v3 width),
    written beside it: a DreamBooth LDM checkpoint (f16) whose UNet carries
    its non-EMA weights and differing ``model_ema.*`` shadows, taken with
    ``dreambooth_extract_ema``; a kohya image LoRA (two UNet linears, a UNet
    1x1 conv, two text-encoder linears); two motion LoRAs on the motion
    modules' projections (write_adapter_lora's format; both on every to_q).
    The UNet, VAE and CLIP are loaded with ``load_into`` and moved to the
    card, where every key must equal its host reference (``host_merge``;
    the image layers the shadows, never the non-EMA weights); then the main
    path (phase 3's cut) runs on them, its launches equal to
    ``predicted_launches`` and its outputs finite (``drive``)."""
    import re

    from motionclone_tpu_torch.config import NoiseScheduleConfig
    from motionclone_tpu_torch.models.clip_text import CLIPTextModel
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.models.vae import AutoencoderKL
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline
    from motionclone_tpu_torch.weights.io import save_safetensors
    from motionclone_tpu_torch.weights.load import assemble_state_dicts, load_into

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    unet_cfg, vae_cfg, clip_cfg = sd15_configs()
    unet, clip = saved["unet"], saved["text_encoder"]
    gen = torch.Generator().manual_seed(2025)
    dev_gen = torch.Generator(device=dev).manual_seed(2025)
    # the DreamBooth checkpoint: the image layers in f16 under their LDM
    # keys, and EMA shadows 0.95 w + N(0, 1e-3) beside them
    keys = ldm_unet_keys([k for k in unet if "motion_modules." not in k],
                         unet_cfg.layers_per_block)
    db, want = {}, {"unet": dict(unet), "vae": saved["vae"], "text_encoder": dict(clip)}
    non_ema = {}
    for k, ldm in keys.items():
        w = unet[k].to(dev)
        db[ldm] = non_ema[k] = w.half().cpu()
        shadow = (0.95 * w.float() + 1e-3 * torch.randn(w.shape, generator=dev_gen, device=dev))
        db["model_ema." + "".join(ldm.split(".")[1:])] = want["unet"][k] = shadow.half().cpu()
    torch.save({"state_dict": db}, os.path.join(root, "dreambooth_ema.ckpt"))
    n_ema = sum(k.startswith("model_ema.") for k in db)
    del db
    # the kohya image LoRA
    merges = {}
    conv = next(k for k in sorted(keys) if k.endswith("proj_in.weight") and unet[k].ndim == 4)
    image = {}
    for prefix, sub, k in (
            ("lora_unet", "unet", "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"),
            ("lora_unet", "unet", "up_blocks.3.attentions.2.transformer_blocks.0.attn2.to_k.weight"),
            ("lora_unet", "unet", conv),
            ("lora_te", "text_encoder", "text_model.encoder.layers.0.self_attn.q_proj.weight"),
            ("lora_te", "text_encoder",
             f"text_model.encoder.layers.{clip_cfg.num_layers - 1}.mlp.fc1.weight")):
        w = want[sub][k]
        up, down = lora_pair(gen, w.shape[0], w.shape[1], 8, conv=w.ndim == 4)
        name = f"{prefix}_{k[:-len('.weight')].replace('.', '_')}"
        image.update({name + ".lora_up.weight": up, name + ".lora_down.weight": down,
                      name + ".alpha": torch.tensor(8.0)})
        merges.setdefault((sub, k), []).append((IMAGE_LORA_ALPHA, up, down))
    save_safetensors(os.path.join(root, "image_lora.safetensors"), image)
    # the motion LoRAs: every to_q in both, then to_v in the first and
    # to_out in the second
    motion_paths = []
    for i, (alpha, projs) in enumerate(zip(MOTION_LORA_ALPHAS,
                                           (("to_q", "to_v"), ("to_q", "to_out.0")))):
        lora = {}
        for k, w in unet.items():
            m = re.fullmatch(r"(.*motion_modules\..*attention_blocks\.\d+)\.(to_\w+(?:\.0)?)"
                             r"\.weight", k)
            if m is None or m.group(2) not in projs:
                continue
            up, down = lora_pair(gen, w.shape[0], w.shape[1], 16)
            prefix = f"{m.group(1)}.processor.{m.group(2).replace('.0', '')}_lora"
            lora.update({prefix + ".down.weight": down, prefix + ".up.weight": up})
            merges.setdefault(("unet", k), []).append((alpha, up, down))
        motion_paths.append(os.path.join(root, f"motion_lora_{i}.ckpt"))
        torch.save(lora, motion_paths[-1])
    for (sub, k), ms in merges.items():
        want[sub][k] = host_merge(want[sub][k], ms)
    write_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    sds = assemble_state_dicts(
        os.path.join(root, "sd"), motion_module_path=os.path.join(root, "mm.ckpt"),
        dreambooth_path=os.path.join(root, "dreambooth_ema.ckpt"),
        lora_model_path=os.path.join(root, "image_lora.safetensors"),
        lora_alpha=IMAGE_LORA_ALPHA,
        motion_lora_configs=list(zip(motion_paths, MOTION_LORA_ALPHAS)),
        dreambooth_extract_ema=True)
    dtype = torch.bfloat16
    modules = {
        "unet": load_into(lambda: UNet3DConditionModel(unet_cfg), sds["unet"], dtype, "unet"),
        "vae": load_into(lambda: AutoencoderKL(vae_cfg), sds["vae"], dtype, "vae"),
        "text_encoder": load_into(lambda: CLIPTextModel(clip_cfg), sds["text_encoder"], dtype,
                                  "text_encoder")}
    del sds
    modules = {name: m.to(dev) for name, m in modules.items()}
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    # every key on the card against its host reference
    faults = []
    for name, module in modules.items():
        got = module.state_dict()
        ref = {k: v for k, v in want[name].items()
               if not k.endswith(("pos_encoder.pe", "position_ids"))}
        if sorted(got) != sorted(ref):
            faults.append(f"{name}: other keys than the host reference")
            continue
        for k, v in ref.items():
            if not torch.equal(got[k], v.to(dtype).to(dev)):
                faults.append(f"{name} {k} differs from the host reference")
            elif name == "unet" and k in non_ema and torch.equal(
                    got[k], non_ema[k].to(dtype).to(dev)):
                faults.append(f"unet {k} is the non-EMA weight, not its shadow")
    if faults:
        raise AssertionError(f"merged weights: {len(faults)} faults, e.g. {faults[:5]}")
    log(f"merged weights: every key of the UNet, VAE and CLIP equals its host reference on "
        f"the card, bit for bit in bf16: {len(merges)} merged (3 UNet and 2 CLIP kohya "
        f"targets, {len(merges) - 5} motion-LoRA projections), {len(keys)} UNet image layers "
        f"from {n_ema} EMA shadows; written in {write_s:.1f} s, assembled and loaded in "
        f"{load_s:.1f} s")

    cfg = t2v_config()
    gen = torch.Generator(device=dev).manual_seed(1234)
    ids = torch.randint(0, clip_cfg.vocab_size, (2, 77), generator=gen, device=dev)
    video = torch.rand(cfg.video_length, cfg.height, cfg.width, 3, generator=gen,
                       device=dev) * 2 - 1
    pipe = MotionClonePipeline(unet_cfg, NoiseScheduleConfig(), cfg, modules["unet"],
                               vae=modules["vae"], text_encoder=modules["text_encoder"],
                               device=dev, dtype=dtype)
    run = drive(pipe, ids, video, wrappers)
    want_launches = predicted_launches(pipe.fns.schedule(), cfg.guidance_steps, True, False)
    differs = [f"{n} {run['launches'][n]}/{c}" for n, c in want_launches.items()
               if run["launches"][n] != c]
    missing = [n for n in CLI_KERNELS if run["launches"][n] <= 0]
    if differs or missing:
        raise AssertionError(f"merged weights: launches (measured/predicted) differ: {differs}; "
                             f"never launched: {missing}")
    counts = ", ".join(f"{n} {run['launches'][n]}" for n in CLI_KERNELS)
    log(f"merged weights: main path at phase 3's cut ({cfg.inference_steps} steps, "
        f"{cfg.guidance_steps} guided) on the merged weights, launches as predicted "
        f"({counts}), outputs finite")
    del pipe, modules, run
    torch.cuda.empty_cache()
    log(f"merged weights: {time.perf_counter() - t0:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")


# ---------------------------------------------------------------------------
# phase 8: the i2v CLI at SD1.5 width, both SparseCtrl flavours
# ---------------------------------------------------------------------------

# i2v_sketch's schedule, cut from configs/i2v_sketch.yaml's 200 steps (120
# guided) so that the script stays well inside its time; i2v_rgb runs its
# full 100 steps (40 guided)
I2V_SKETCH_CUT = {"inference_steps": 50, "guidance_steps": 30}
# the reference workloads' prompts (configs/i2v_{rgb,sketch}.jsonl), no seed:
# the CLI's default seed (76739) applies
I2V_PROMPTS = {"rgb": "Dog, lying on the grass", "sketch": "Lion, walks in the forest"}


def write_png(path: str, rgb) -> None:
    """An 8-bit RGB PNG of a uint8 (H, W, 3) array (zlib, no row filter)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_controlnet(root: str, dev, unet_cfg, flavour: str) -> dict:
    """A SparseCtrl-shaped ``.ckpt`` of ``flavour`` at the width of
    ``unet_cfg`` with seeded random weights (init_scaled_: no zero head),
    saved in bf16 with the ``pos_encoder.pe`` buffers (32 rows) and the
    ``animatediff_config`` entry a SparseCtrl checkpoint carries; the
    flavour's sparsectrl YAML beside it.  Returns the saved state dict."""
    import shutil

    from motionclone_tpu_torch.models.sparse_controlnet import SparseControlNetModel

    gen = torch.Generator(device=dev).manual_seed({"rgb": 4321, "sketch": 8765}[flavour])
    model = build_model(SparseControlNetModel, controlnet_config(unet_cfg, flavour), dev, gen,
                        torch.bfloat16)
    saved = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    ckpt = dict(saved)
    for key, w in saved.items():
        if key.endswith(".to_q.weight") and "motion_modules." in key:
            ckpt[key[: -len("to_q.weight")] + "pos_encoder.pe"] = torch.zeros(
                1, 32, w.shape[0], dtype=torch.bfloat16)
    ckpt["animatediff_config"] = {"controlnet": flavour, "note": "not a tensor"}
    torch.save(ckpt, os.path.join(root, f"sparsectrl_{flavour}.ckpt"))
    here = os.path.dirname(os.path.abspath(__file__))
    name = {"rgb": "latent_condition.yaml", "sketch": "image_condition.yaml"}[flavour]
    shutil.copy(os.path.join(here, "configs", "sparsectrl", name),
                os.path.join(root, f"sparsectrl_{flavour}.yaml"))
    torch.cuda.empty_cache()
    return saved


def write_adapter_lora(root: str, unet_sd: dict, rank: int = 32) -> list:
    """A diffusers-format adapter LoRA (``processor.to_q_lora.down.weight``
    naming, as AnimateDiff v3's adapter) on every q, k, v and out
    projection of the UNet's spatial attentions, seeded random float32
    weights; returns the merged targets' keys."""
    import re

    gen = torch.Generator().manual_seed(99)
    lora, targets = {}, []
    for key, w in unet_sd.items():
        m = re.fullmatch(r"(.*\.attn[12])\.(to_q|to_k|to_v|to_out\.0)\.weight", key)
        if m is None or "motion_modules." in key:
            continue
        proj = m.group(2).replace(".0", "")
        out_ch, in_ch = w.shape
        prefix = f"{m.group(1)}.processor.{proj}_lora"
        lora[prefix + ".down.weight"] = torch.randn(rank, in_ch, generator=gen) * in_ch ** -0.5
        lora[prefix + ".up.weight"] = torch.randn(out_ch, rank, generator=gen) * 0.01
        targets.append(key)
    torch.save(lora, os.path.join(root, "adapter_lora.ckpt"))
    return targets


def write_i2v_config(root: str, flavour: str) -> str:
    """configs/i2v_{flavour}.yaml with only its asset paths changed (and,
    for the sketch flavour, the schedule cut to I2V_SKETCH_CUT)."""
    here = os.path.dirname(os.path.abspath(__file__))
    assets = {"motion_module": "mm.ckpt", "dreambooth_path": "",
              "model_config": "model_config.yaml",
              "controlnet_path": f"sparsectrl_{flavour}.ckpt",
              "controlnet_config": f"sparsectrl_{flavour}.yaml",
              "adapter_lora_path": "adapter_lora.ckpt"}
    cut = I2V_SKETCH_CUT if flavour == "sketch" else {}
    lines = []
    with open(os.path.join(here, "configs", f"i2v_{flavour}.yaml")) as fh:
        for line in fh:
            key = line.split(":", 1)[0]
            if key in assets:
                line = f'{key}: "{assets[key]}"\n'
            elif key in cut:
                line = f"{key}: {cut[key]}\n"
            lines.append(line)
    path = os.path.join(root, f"i2v_{flavour}.yaml")
    with open(path, "w") as fh:
        fh.writelines(lines)
    return path


def i2v_cli(dev, wrappers, card: str, root: str, saved: dict) -> dict:
    """Phase 8: the port's ``cli.i2v_main`` on ``dev`` for both SparseCtrl
    flavours, from phase 7's model directory in ``root`` (its saved state
    dicts ``saved``) plus an adapter LoRA, a controlnet per flavour and a
    512 x 512 condition PNG, the reference clip's first frame, at
    image_index [0].  Returns each flavour's launches and the saved RGB
    controlnet."""
    side, frames = 512, 16
    clip = reference_clip(frames, side)
    stubbed = stub_codec(clip)
    out = {}
    t0 = time.perf_counter()
    unet_cfg = sd15_configs()[0]
    lora_targets = write_adapter_lora(root, saved["unet"])
    saved_cn = {f: write_controlnet(root, dev, unet_cfg, f) for f in ("rgb", "sketch")}
    if stubbed is None:
        write_png(os.path.join(root, "condition.png"), clip[0])
    write_s = time.perf_counter() - t0
    log(f"i2v CLI: adapter LoRA (on {len(lora_targets)} projections) and controlnets "
        f"written beside phase 7's model directory in {write_s:.1f} s")
    for flavour in ("rgb", "sketch"):
        out[flavour] = i2v_cli_run(root, flavour, dev, wrappers, card, saved,
                                   saved_cn[flavour], lora_targets, stubbed)
    out["saved_rgb_controlnet"] = saved_cn["rgb"]
    torch.cuda.empty_cache()
    return out


def i2v_argv(root: str, flavour: str, dev, out: str) -> list:
    side, frames = 512, 16
    return ["--pretrained-model-path", os.path.join(root, "sd"),
            "--inference_config", os.path.join(root, f"i2v_{flavour}.yaml"),
            "--examples", os.path.join(root, f"examples_{flavour}.jsonl"),
            "--motion-representation-save-dir", os.path.join(root, f"reps_{flavour}"),
            "--generated-videos-save-dir", os.path.join(root, out),
            "--config-root", root, "--device", str(dev),
            "--W", str(side), "--H", str(side), "--L", str(frames)]


def i2v_cli_run(root, flavour, dev, wrappers, card, saved, saved_cn, lora_targets,
                stubbed) -> dict:
    """One flavour of phase 8: ``cli.i2v_main`` with the launch counts set
    to 0 just before and read just after."""
    from motionclone_tpu_torch import cli
    from motionclone_tpu_torch.models.sparse_controlnet import SparseControlNetModel

    side, frames, prompt = 512, 16, I2V_PROMPTS[flavour]
    with open(os.path.join(root, f"examples_{flavour}.jsonl"), "w") as fh:
        fh.write(json.dumps({"video_path": "reference.mp4", "new_prompt": prompt,
                             "condition_image_paths": ["condition.png"],
                             "image_index": [0]}) + "\n")
    write_i2v_config(root, flavour)
    argv = i2v_argv(root, flavour, dev, f"out_{flavour}")
    # the controlnet's passes: how many, and the first one's residuals
    passes = []
    forward = SparseControlNetModel.forward

    def spy(self, *args, **kwargs):
        res = forward(self, *args, **kwargs)
        passes.append(res if not passes else None)
        return res

    SparseControlNetModel.forward = spy
    try:
        run = run_cli(cli.i2v_main, argv, wrappers)
    finally:
        SparseControlNetModel.forward = forward
    rt, paths, launches, video_s, peak_gb = (run.pop(k) for k in ("rt", "paths", "launches",
                                                                   "seconds", "peak_gb"))
    cfg, timings = rt.infer_cfg, rt.timings
    tag = f"i2v_{flavour} CLI"
    cut = (f"; schedule cut from configs/i2v_sketch.yaml's 200 steps (120 guided) to "
           f"{cfg.inference_steps} ({cfg.guidance_steps} guided)" if flavour == "sketch"
           else " (configs/i2v_rgb.yaml's)")
    log(f"{tag}: schedule {cfg.inference_steps} steps, {cfg.guidance_steps} guided{cut}; "
        f"{side}x{side}x{frames}, bf16, random weights, controlnet scale "
        f"{cfg.controlnet_scale}")
    g, v = cfg.guidance_steps, cfg.inference_steps - cfg.guidance_steps
    differs = []
    for name, n in launches.items():
        ext, per_g, per_v = PREDICTED_I2V_LAUNCHES[name]
        want = ext + g * per_g + v * per_v
        log(f"{tag} launches {name:25s} measured {n:5d} predicted {want:5d}"
            f"{'' if n == want else '  DIFFERS'}")
        if n != want:
            differs.append(name)
    if differs:
        raise AssertionError(f"{tag}: launches differ from the prediction: {differs}")
    if len(passes) != 1 + cfg.inference_steps:
        raise AssertionError(f"{tag}: {len(passes)} controlnet passes, not "
                             f"1 + {cfg.inference_steps}")
    down, mid = passes[0]
    for r in down + (mid,):
        if not bool(torch.isfinite(r.float()).all()) or not float(r.abs().max()) > 0:
            raise AssertionError(f"{tag}: a residual is non-finite or zero")
    # the loaded controlnet equals what was saved, bit for bit; the adapter
    # LoRA moved its targets and nothing else of the UNet
    cn = rt.pipeline.controlnet.state_dict()
    if sorted(cn) != sorted(saved_cn):
        raise AssertionError(f"{tag}: the loaded controlnet has other keys than were saved")
    for k, want in saved_cn.items():
        got = cn[k]
        if got.dtype != torch.bfloat16 or not torch.equal(got.cpu().view(torch.int16),
                                                          want.view(torch.int16)):
            raise AssertionError(f"{tag}: loaded controlnet {k} differs from what was saved")
    unet = rt.pipeline.unet.state_dict()
    moved = [k for k in lora_targets if not torch.equal(unet[k].cpu(), saved["unet"][k])]
    if len(moved) != len(lora_targets):
        raise AssertionError(f"{tag}: the adapter LoRA moved {len(moved)} of "
                             f"{len(lora_targets)} targets")
    name = "reference_" + (prompt + cfg.positive_prompt).strip().replace(" ", "_") \
        + "76739_76739.mp4"
    if paths != [os.path.join(root, f"out_{flavour}", name)]:
        raise AssertionError(f"{tag} wrote {paths}, not {name}")
    check_video(tag, read_output(paths, stubbed), frames, side)
    # one controlnet pass alone on the CFG pair, as every step runs it
    from motionclone_tpu_torch.config import load_examples

    example = load_examples(os.path.join(root, f"examples_{flavour}.jsonl"))[0]
    cond, mask, scale = rt.sampling_condition(example, 76739, cfg.controlnet_scale, root)
    uncond, cond_emb = rt.encode_prompt(prompt, cfg.negative_prompt)
    lat2 = torch.randn(2, frames, side // 8, side // 8, 4, device=dev, dtype=torch.bfloat16)
    args = (lat2, 500, torch.cat([uncond, cond_emb]), torch.cat([cond, cond]).to(dev),
            torch.cat([mask, mask]).to(dev), scale)
    with torch.no_grad():
        pass_ms = time_ms(lambda: rt.pipeline.controlnet(*args, impl="fused"), reps=5)
    del args, lat2, cond, mask
    median = lambda ms: sorted(ms)[len(ms) // 2]
    gm, vm = timings["guided_ms"], timings["vanilla_ms"]
    for line in (
            f"weights loaded in {rt.load_seconds:.1f} s (controlnet and adapter LoRA "
            f"included)",
            f"one controlnet pass on the CFG pair (B·F = 32, fused) {pass_ms:.1f} ms",
            f"tokenizer + CLIP {timings['text']:.3f} s",
            f"extraction {timings['extract']:.2f} s (controlnet pass included)",
            f"condition image {timings['condition']:.3f} s",
            f"sampling {timings['sample']:.2f} s: ms per guided step median "
            f"{median(gm):.1f} (min {min(gm):.1f}, max {max(gm):.1f}, {len(gm)} steps), "
            f"per vanilla step median {median(vm):.1f} (min {min(vm):.1f}, "
            f"max {max(vm):.1f}, {len(vm)} steps)",
            f"decode + write {timings['decode_write']:.2f} s",
            f"peak device memory {peak_gb:.2f} GB",
            f"seconds per video from the CLI: {video_s:.1f} (weights load included), "
            f"{video_s - rt.load_seconds:.1f} (excluded)"):
        log(f"{tag} {line} [{card}]")
    del rt, passes, down, mid
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9: the approx caches, the weights cache and resume through the CLIs
# ---------------------------------------------------------------------------

# the JAX package's recommended operating point, and the finer caches
APPROX_STEP = "step-extrap:3"
APPROX_FINER = "uncond-extrap:3,guidance-cache:2"
# where the card's kernels give other bits for the same inputs, a rerun is
# held to phase 4's tolerance of the noise prediction (relative L2)
RERUN_TOL = 3e-2
# every cache on: the build whose overrides at 1 must be the exact path
ALL_CACHES = dict(uncond_interval=2, guidance_interval=2, uncond_extrap=1.0, step_interval=2,
                  step_extrap=1.0)


def predicted_launches(sched, guidance_steps: int, extraction: bool,
                       controlnet: bool) -> dict:
    """The launches of a sampling run from its schedule's flags
    (``SamplingFns.schedule``): per full guided step the controlnet pass
    (i2v), the uncond forward where fresh, and the guidance pass where
    fresh or else a plain conditional forward; per full vanilla step the
    controlnet pass and one plain forward (the CFG pair, or the conditional
    half alone on a stale-uncond step: the modules route alike at B·F 16
    and 32); nothing on a skip step; extraction's where it ran.  A plain
    forward launches what a vanilla step does, the guidance pass the rest
    of a guided step's PREDICTED_LAUNCHES."""
    out = {}
    for name, (ext, per_g, per_v) in PREDICTED_LAUNCHES.items():
        cn = PREDICTED_CONTROLNET_LAUNCHES.get(name, 0) if controlnet else 0
        plain, grad = per_v, per_g - per_v
        n = ext + cn if extraction else 0
        for i in np.flatnonzero(sched.full):
            if i < guidance_steps:
                n += cn + (plain if sched.uncond[i] else 0) + (grad if sched.guidance[i]
                                                               else plain)
            else:
                n += cn + plain
        out[name] = int(n)
    return out


def check_launches(tag: str, run: dict, controlnet: bool) -> None:
    rt = run["rt"]
    want = predicted_launches(rt.pipeline.fns.schedule(), rt.infer_cfg.guidance_steps,
                              "extract" in rt.timings, controlnet)
    differs = []
    for name, n in run["launches"].items():
        log(f"{tag} launches {name:25s} measured {n:5d} predicted {want[name]:5d}"
            f"{'' if n == want[name] else '  DIFFERS'}")
        if n != want[name]:
            differs.append(name)
    if differs:
        raise AssertionError(f"{tag}: launches differ from the prediction: {differs}")


def same_or_close(what: str, got, want) -> None:
    """``got`` equals ``want`` bit for bit, or, where the card's kernels
    gave other bits for the same inputs, within RERUN_TOL (said so)."""
    if torch.equal(got, want):
        log(f"{what}: equal bit for bit")
        return
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    log(f"{what}: NOT bit for bit: relative L2 {rel:.3e}, max abs difference "
        f"{(got.float() - want.float()).abs().max().item():.3e} (tol {RERUN_TOL:.0e}); the "
        f"card's kernels gave other bits for the same inputs")
    if rel > RERUN_TOL:
        raise AssertionError(f"{what}: relative L2 {rel}")


def stepped_sample(fns, infer, latents, uncond, cond, rep):
    """The exact schedule driven one step at a time through ``guided_step``
    and ``vanilla_step``, which ``sample``'s cached steps equal with every
    flag true."""
    from motionclone_tpu_torch.diffusion.ddim import prev_timesteps
    from motionclone_tpu_torch.diffusion.guidance import ramp_scales

    ts = fns.timesteps
    tps = prev_timesteps(ts)
    ramps = ramp_scales(infer.guidance_steps, infer.warm_up_steps, infer.cool_up_steps)
    for i, (t, tp) in enumerate(zip(ts.tolist(), tps.tolist())):
        if i < infer.guidance_steps:
            latents, _ = fns.guided_step(latents, t, tp, float(ramps[i]), uncond, cond, rep)
        else:
            latents = fns.vanilla_step(latents, t, tp, uncond, cond)
    return latents


def approx_identity(pipe, run) -> None:
    """Phase 9(e), on phase 3's pipeline and cut schedule: the exact steps
    one at a time (``guided_step`` / ``vanilla_step``) against phase 3's
    exact ``sample`` and against the build with every cache on, run with
    every override at 1, from the same latents, embeddings and
    representation."""
    from motionclone_tpu_torch.pipeline.motionclone import make_sampling_fns

    init = pipe.initial_latents(seed=3)
    want = stepped_sample(pipe.fns, pipe.infer_cfg, init, run["uncond"], run["cond"],
                          run["rep"])
    same_or_close("approx (e): the exact sample against its steps one at a time (phase "
                  "3's 4 steps)", run["out"], want)
    fns = make_sampling_fns(pipe.unet, pipe.sched_cfg, pipe.infer_cfg, **ALL_CACHES)
    got = fns.sample(init, run["uncond"], run["cond"], run["rep"],
                     uncond_refresh=1, guidance_refresh=1, step_refresh=1,
                     uncond_extrap_w=1.0, step_extrap_w=1.0)
    same_or_close("approx (e): every cache built, every override at 1, against the exact "
                  "steps one at a time (phase 3's 4 steps)", got, want)


def psnr(a, b) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def log_run(tag: str, run: dict, card: str) -> None:
    """Seconds per video, the full and skip step medians, peak memory."""
    rt = run["rt"]
    t = rt.timings
    median = lambda ms: f"{sorted(ms)[len(ms) // 2]:.1f}" if ms else "-"
    written = (f" (the entry written in {rt.cache_write_seconds:.2f} s besides)"
               if t["weights_cache"] == "miss" else "")
    log(f"{tag}: weights cache {t['weights_cache']}, loaded in {rt.load_seconds:.2f} s"
        f"{written}; "
        f"sampling {t['sample']:.2f} s: ms per guided step median {median(t['guided_ms'])} "
        f"({len(t['guided_ms'])} full), skip {median(t['guided_skip_ms'])} "
        f"({len(t['guided_skip_ms'])}); per vanilla step median {median(t['vanilla_ms'])} "
        f"({len(t['vanilla_ms'])} full), skip {median(t['vanilla_skip_ms'])} "
        f"({len(t['vanilla_skip_ms'])}); peak device memory {run['peak_gb']:.2f} GB; "
        f"seconds per video from the CLI {run['seconds']:.1f} (weights load included), "
        f"{run['seconds'] - rt.load_seconds:.1f} (excluded) [{card}]")


class Interrupted(Exception):
    pass


def approx_cli(dev, wrappers, card: str, root: str, t2v: dict, i2v: dict) -> None:
    """Phase 9: ``--approx``, ``--weights-cache`` and ``--resume`` through
    the CLIs, on phase 7's and phase 8's model directories in ``root``."""
    from motionclone_tpu_torch import cli
    from motionclone_tpu_torch.models.sparse_controlnet import SparseControlNetModel

    side, frames = 512, 16
    stubbed = stub_codec(reference_clip(frames, side))
    wc = os.path.join(root, "weights_cache")

    # (a) step-extrap:3, cold weights cache, resume on (uninterrupted)
    argv_a = t2v_argv(root, dev, "out_9a") + ["--approx", APPROX_STEP, "--weights-cache", wc,
                                              "--resume"]
    a = run_cli(cli.t2v_main, argv_a, wrappers)
    tag = f"approx (a) t2v_camera --approx {APPROX_STEP}"
    if a["rt"].timings["weights_cache"] != "miss":
        raise AssertionError(f"{tag}: the first run's weights cache was not a miss")
    check_launches(tag, a, controlnet=False)
    video = read_output(a["paths"], stubbed)
    check_video(tag, video, frames, side)
    rel = ((a["latents"] - t2v["latents"]).norm() / t2v["latents"].norm()).item()
    log(f"{tag}: against phase 7's exact run (random weights, so not a quality figure): "
        f"final latents relative L2 {rel:.3e}, frames PSNR {psnr(video, t2v['video']):.2f} dB")
    log_run(tag, a, card)
    if any(f.startswith(".resume_") for f in os.listdir(os.path.join(root, "out_9a"))):
        raise AssertionError(f"{tag}: the resume checkpoint outlived the run")
    cold_s, a_latents = a["rt"].load_seconds, a["latents"]
    del a
    torch.cuda.empty_cache()

    # (b) the finer caches, a weights-cache hit
    b = run_cli(cli.t2v_main, t2v_argv(root, dev, "out_9b")
                + ["--approx", APPROX_FINER, "--weights-cache", wc], wrappers)
    tag = f"approx (b) t2v_camera --approx {APPROX_FINER}"
    if b["rt"].timings["weights_cache"] != "hit":
        raise AssertionError(f"{tag}: the second run's weights cache was not a hit")
    check_loaded(b["rt"], t2v["saved"])
    check_launches(tag, b, controlnet=False)
    video = read_output(b["paths"], stubbed)
    check_video(tag, video, frames, side)
    rel = ((b["latents"] - t2v["latents"]).norm() / t2v["latents"].norm()).item()
    log(f"{tag}: against phase 7's exact run (random weights): final latents relative L2 "
        f"{rel:.3e}, frames PSNR {psnr(video, t2v['video']):.2f} dB")
    log_run(tag, b, card)
    log(f"approx t2v weights: loaded in {t2v['load_seconds']:.2f} s without the cache "
        f"(phase 7), {cold_s:.2f} s cold (a miss; the entry's write excluded), "
        f"{b['rt'].load_seconds:.2f} s warm (a hit), every parameter equal to phase 7's "
        f"bit for bit [{card}]")
    log(f"approx t2v seconds per video (load included): exact {t2v['seconds']:.1f} "
        f"(phase 7), sampling {t2v['sample_seconds']:.2f} s [{card}]")
    del b
    torch.cuda.empty_cache()

    # (d) resume: interrupted after the guided chunk, then run again
    def stop(done, total):
        if done == t2v["guidance_steps"]:
            raise Interrupted

    argv_d = t2v_argv(root, dev, "out_9d") + ["--approx", APPROX_STEP, "--weights-cache", wc,
                                              "--resume"]
    try:
        run_cli(cli.t2v_main, argv_d, wrappers, on_chunk=stop)
        raise AssertionError("approx (d): the run was not interrupted")
    except Interrupted:
        pass
    left = [f for f in os.listdir(os.path.join(root, "out_9d")) if f.startswith(".resume_")]
    if len(left) != 1:
        raise AssertionError(f"approx (d): the interrupted run left {left}")
    d = run_cli(cli.t2v_main, argv_d, wrappers)
    tag = "approx (d) t2v_camera resume"
    t = d["rt"].timings
    if t["guided_ms"] or t["guided_skip_ms"] or not t["vanilla_ms"]:
        raise AssertionError(f"{tag}: the rerun did not continue at the vanilla chunk")
    same_or_close(f"{tag}: rerun after the guided chunk against (a)'s uninterrupted run, "
                  f"final latents", d["latents"], a_latents)
    log_run(tag, d, card)
    del d
    torch.cuda.empty_cache()

    # (c) i2v_rgb under step-extrap:3, weights cache miss then hit
    passes = []
    forward = SparseControlNetModel.forward

    def spy(self, *args, **kwargs):
        passes.append(1)
        return forward(self, *args, **kwargs)

    SparseControlNetModel.forward = spy
    try:
        for i, state in enumerate(("miss", "hit")):
            passes.clear()
            c = run_cli(cli.i2v_main, i2v_argv(root, "rgb", dev, f"out_9c{i}")
                        + ["--approx", APPROX_STEP, "--weights-cache", wc], wrappers)
            rt = c["rt"]
            tag = f"approx (c{i}) i2v_rgb --approx {APPROX_STEP}"
            if rt.timings["weights_cache"] != state:
                raise AssertionError(f"{tag}: the weights cache was not a {state}")
            check_launches(tag, c, controlnet=True)
            full = int(rt.pipeline.fns.schedule().full.sum())
            want = full + ("extract" in rt.timings)
            log(f"{tag}: {len(passes)} controlnet passes, {full} full steps of "
                f"{rt.infer_cfg.inference_steps}")
            if len(passes) != want:
                raise AssertionError(f"{tag}: {len(passes)} controlnet passes, not {want}")
            check_video(tag, read_output(c["paths"], stubbed), frames, side)
            if state == "hit":
                got = rt.pipeline.controlnet.state_dict()
                for k, v in i2v["saved_rgb_controlnet"].items():
                    if not torch.equal(got[k].cpu().view(torch.int16), v.view(torch.int16)):
                        raise AssertionError(f"{tag}: cached controlnet {k} differs")
            log_run(tag, c, card)
            del c, rt
            torch.cuda.empty_cache()
    finally:
        SparseControlNetModel.forward = forward


# ---------------------------------------------------------------------------
# phase 10: the sweep and the server
# ---------------------------------------------------------------------------

# (b)-(e) run t2v_camera and i2v_rgb with their schedules cut to these
SWEEP_CUT = {"inference_steps": 10, "guidance_steps": 5}
I2V_SWEEP_CUT = {"inference_steps": 10, "guidance_steps": 4}
# (a)'s examples: the reference clip under two prompts and seeds (the
# first is phase 7's example, whose run is its serial reference); the
# second names a copy of the clip, so each has its own representation file
SWEEP_EXAMPLES = (("reference.mp4", "Relics on the seabed", 42),
                  ("reference_b.mp4", "A lighthouse on a cliff at dusk", 7))
# (d)'s controlnet scale of each example
I2V_SWEEP_SCALES = (0.5, 1.0)
# a batched example against the same example run alone (final latents,
# relative L2): at twice the rows the unfused differentiated pass may take
# other cuBLAS and cuDNN algorithms, so the bits differ and the random
# weights amplify the difference over the steps as they amplify any bf16
# rounding; phase 6's bound on the latents of a run that rounds otherwise
BATCH_TOL = 5e-2


class Counting:
    """Counts the calls of ``owner.name`` while active, keeping each
    call's ``keep(args)``."""

    def __init__(self, owner, name: str, keep=lambda args: None):
        self.owner, self.name, self.keep, self.calls = owner, name, keep, []

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)

        def spy(*args, **kwargs):
            self.calls.append(self.keep(args))
            return self.orig(*args, **kwargs)

        setattr(self.owner, self.name, spy)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def write_cut_yaml(src: str, dst: str, cut: dict) -> str:
    """``src`` with the schedule keys of ``cut`` replaced, written to ``dst``."""
    with open(src) as fh:
        lines = [f"{k}: {cut[k]}\n" if (k := line.split(":", 1)[0]) in cut else line
                 for line in fh]
    with open(dst, "w") as fh:
        fh.writelines(lines)
    return dst


def write_examples(path: str, examples) -> str:
    with open(path, "w") as fh:
        for example in examples:
            fh.write(json.dumps(example) + "\n")
    return path


def check_videos(tag: str, paths, names, stubbed, root: str, out: str, frames: int,
                 side: int) -> None:
    """Each written video is frames x side x side x 3 uint8 and not
    constant, with the reference's names."""
    if list(paths) != [os.path.join(root, out, n) for n in names]:
        raise AssertionError(f"{tag} wrote {paths}, not {names}")
    for path in paths:
        check_video(tag, read_output([path], stubbed), frames, side)


def sweep_name(video: str, prompt: str, seed: int, positive: str) -> str:
    return (os.path.splitext(video)[0] + "_" + (prompt + positive).strip().replace(" ", "_")
            + f"{seed}_{seed}.mp4")


def http(port: int, path: str, payload=None):
    """(status, body) of one request to the server on 127.0.0.1."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            body = r.read().decode()
            code = r.status
    except urllib.error.HTTPError as e:
        body, code = e.read().decode(), e.code
    return code, (json.loads(body) if body.startswith(("{", "[")) else body)


def wait_job(port: int, job_id: str, statuses, timeout_s: float) -> dict:
    deadline = time.time() + timeout_s
    while True:
        _, rec = http(port, f"/jobs/{job_id}")
        if rec["status"] in statuses:
            return rec
        if time.time() > deadline:
            raise AssertionError(f"serve: job {job_id} still {rec['status']} after "
                                 f"{timeout_s:.0f} s")
        time.sleep(0.05)


def sweep_cli(dev, wrappers, card: str, root: str, t2v: dict) -> None:
    """Phase 10: ``cli.sweep_main`` and ``cli.serve_main`` on phase 7's model
    directory in ``root`` (and phase 8's i2v_rgb controlnet, phase 9's
    weights cache): (a) a batch of 2 examples at the full t2v_camera
    schedule, each against itself run alone; (b) the same batch at a cut
    schedule, a representation-cache hit; (c) (b) interrupted after the
    guided chunk and resumed; (d) an i2v_rgb batch of 2 with two controlnet
    scales; (e) the server, 3 jobs: one alone, two as one batch."""
    import shutil
    import threading

    from motionclone_tpu_torch import cli
    from motionclone_tpu_torch.diffusion.guidance import load_motion_representation
    from motionclone_tpu_torch.models.sparse_controlnet import SparseControlNetModel
    from motionclone_tpu_torch.models.vae import AutoencoderKL
    from motionclone_tpu_torch.pipeline import runner
    from motionclone_tpu_torch.pipeline import sweep as sweep_mod
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    side, frames = 512, 16
    stubbed = stub_codec(reference_clip(frames, side))
    if stubbed is None:
        shutil.copy(os.path.join(root, "reference.mp4"), os.path.join(root, "reference_b.mp4"))
    wc = os.path.join(root, "weights_cache")
    examples = write_examples(os.path.join(root, "examples_10.jsonl"), [
        {"video_path": v, "new_prompt": p, "seed": s} for v, p, s in SWEEP_EXAMPLES])
    t2v_cut = write_cut_yaml(os.path.join(root, "t2v.yaml"), os.path.join(root, "t2v_cut.yaml"),
                             SWEEP_CUT)

    def argv(out, reps, cfg=os.path.join(root, "t2v.yaml"), ex=examples):
        return t2v_argv(root, dev, out) + [
            "--inference_config", cfg, "--examples", ex, "--weights-cache", wc,
            "--motion-representation-save-dir", os.path.join(root, reps)]

    # (a) one batch of 2 at the full schedule
    with Counting(MotionClonePipeline, "encode_text") as clip_calls:
        a = run_cli(cli.sweep_main, argv("out_10a", "reps_10") + ["--num-devices", "2"],
                    wrappers)
    rt, t = a["rt"], a["rt"].timings
    cfg = rt.infer_cfg
    tag = "sweep (a) t2v_camera, a batch of 2"
    log(f"{tag}: schedule {cfg.inference_steps} steps, {cfg.guidance_steps} guided "
        f"(configs/t2v_camera.yaml's), {side}x{side}x{frames}, bf16, random weights")
    check_launches(tag, a, controlnet=False)
    if len(clip_calls) != 1:
        raise AssertionError(f"{tag}: {len(clip_calls)} CLIP calls, not 1")
    names = [sweep_name(v, p, s, cfg.positive_prompt) for v, p, s in SWEEP_EXAMPLES]
    check_videos(tag, a["paths"], names, stubbed, root, "out_10a", frames, side)
    median = lambda ms: sorted(ms)[len(ms) // 2]
    per_batch = a["seconds"] - rt.load_seconds
    log(f"{tag}: seconds per batch {per_batch:.1f} (weights load excluded; "
        f"{a['seconds']:.1f} with it), per video {per_batch / 2:.1f}; tokenizer + CLIP "
        f"{t['text']:.3f} s (one call), extraction {t['extract']:.2f} s, sampling "
        f"{t['sample']:.2f} s: ms per guided step median {median(t['guided_ms']):.1f}, "
        f"per vanilla step median {median(t['vanilla_ms']):.1f} (batch of 2), decode + "
        f"write {t['decode_write']:.2f} s; peak device memory {a['peak_gb']:.2f} GB [{card}]")
    batched = a["latents"]
    del a, rt
    torch.cuda.empty_cache()
    # each example alone: the first is phase 7's run, the second runs now
    alone = write_examples(os.path.join(root, "examples_10_alone.jsonl"), [
        {"video_path": v, "new_prompt": p, "seed": s} for v, p, s in SWEEP_EXAMPLES[1:]])
    second = run_cli(cli.t2v_main, argv("out_10s", "reps_10s", ex=alone), wrappers)
    # the rounding control: phase 7's example alone from initial latents one
    # bf16 ulp away, on phase 7's representation
    rt = second["rt"]
    rep = {k: (v.to(dev), i.to(dev)) for k, (v, i) in load_motion_representation(
        os.path.join(root, "reps", "reference.npz")).items()}
    uncond, cond = rt.encode_prompt(SWEEP_EXAMPLES[0][1] + cfg.positive_prompt,
                                    cfg.negative_prompt)
    init = rt.pipeline.initial_latents(SWEEP_EXAMPLES[0][2])
    nudged = (init.view(torch.int16) ^ 1).view(torch.bfloat16)
    control = rel_l2(rt.pipeline.fns.sample(nudged, uncond, cond, rep).float().cpu(),
                     t2v["latents"])
    del rt, rep, init, nudged
    for i, want in enumerate((t2v["latents"], second["latents"])):
        rel = rel_l2(batched[i: i + 1], want)
        log(f"{tag}: example {i + 1} batched against itself alone (phase "
            f"{7 if i == 0 else 10}): final latents relative L2 {rel:.3e} (tol "
            f"{BATCH_TOL:.0e}); rounding control, phase 7's example alone from initial "
            f"latents one bf16 ulp away: {control:.3e}")
        if not rel <= BATCH_TOL:
            raise AssertionError(f"{tag}: example {i + 1} batched deviates {rel} from alone")
    log(f"{tag}: example 2 alone {second['seconds']:.1f} s, sampling "
        f"{second['rt'].timings['sample']:.2f} s [{card}]")
    del second
    torch.cuda.empty_cache()

    # (b) the same batch at a cut schedule: a representation-cache hit
    cut = (f"schedule cut from configs/t2v_camera.yaml's 100 steps (50 guided) to "
           f"{SWEEP_CUT['inference_steps']} ({SWEEP_CUT['guidance_steps']} guided)")
    with Counting(AutoencoderKL, "encode") as encodes:
        b = run_cli(cli.sweep_main, argv("out_10b", "reps_10", t2v_cut) + ["--num-devices", "2"],
                    wrappers)
    tag = "sweep (b) the batch again, a representation-cache hit"
    log(f"{tag}: {cut}")
    if encodes or "extract" in b["rt"].timings:
        raise AssertionError(f"{tag}: {len(encodes)} VAE encodes, extraction "
                             f"{'ran' if 'extract' in b['rt'].timings else 'skipped'}")
    check_launches(tag, b, controlnet=False)
    check_videos(tag, b["paths"], names, stubbed, root, "out_10b", frames, side)
    log(f"{tag}: no VAE encode, no extraction; {b['seconds']:.1f} s [{card}]")
    cut_latents = b["latents"]
    del b
    torch.cuda.empty_cache()

    # (c) (b) with --resume, interrupted after the guided chunk, run again
    def stop(done, total):
        if done == SWEEP_CUT["guidance_steps"]:
            raise Interrupted

    argv_c = argv("out_10c", "reps_10", t2v_cut) + ["--num-devices", "2", "--resume"]
    try:
        run_cli(cli.sweep_main, argv_c, wrappers, on_chunk=stop)
        raise AssertionError("sweep (c): the run was not interrupted")
    except Interrupted:
        pass
    left = [f for f in os.listdir(os.path.join(root, "out_10c")) if f.startswith(".resume_")]
    if len(left) != 1 or not left[0].startswith(".resume_sweep_"):
        raise AssertionError(f"sweep (c): the interrupted run left {left}")
    c = run_cli(cli.sweep_main, argv_c, wrappers)
    tag = "sweep (c) resume"
    log(f"{tag}: {cut}; interrupted after the guided chunk, {left[0]} kept")
    if c["rt"].timings["guided_ms"] or not c["rt"].timings["vanilla_ms"]:
        raise AssertionError(f"{tag}: the rerun did not continue at the vanilla chunk")
    same_or_close(f"{tag}: rerun after the guided chunk against (b)'s uninterrupted batch, "
                  f"final latents", c["latents"], cut_latents)
    del c
    torch.cuda.empty_cache()

    # (d) an i2v_rgb batch of 2 with two controlnet scales
    i2v_cut = write_cut_yaml(os.path.join(root, "i2v_rgb.yaml"),
                             os.path.join(root, "i2v_rgb_cut.yaml"), I2V_SWEEP_CUT)
    i2v_examples = write_examples(os.path.join(root, "examples_10d.jsonl"), [
        {"video_path": v, "new_prompt": p, "seed": s, "condition_image_paths": ["condition.png"],
         "image_index": [0], "controlnet_scale": scale}
        for (v, p, s), scale in zip(SWEEP_EXAMPLES, I2V_SWEEP_SCALES)])
    keep = lambda args: (args[1].shape[0], args if len(args) > 6 and torch.is_tensor(args[6])
                         else None)
    with Counting(SparseControlNetModel, "forward", keep) as passes:
        d = run_cli(cli.sweep_main, argv("out_10d", "reps_10d", i2v_cut, i2v_examples)
                    + ["--num-devices", "2"], wrappers)
    rt = d["rt"]
    tag = "sweep (d) i2v_rgb, a batch of 2"
    log(f"{tag}: schedule cut from configs/i2v_rgb.yaml's 100 steps (40 guided) to "
        f"{I2V_SWEEP_CUT['inference_steps']} ({I2V_SWEEP_CUT['guidance_steps']} guided); "
        f"controlnet scales {I2V_SWEEP_SCALES}")
    check_launches(tag, d, controlnet=True)
    rows = [n for n, _ in passes]
    if rows != [2] + [4] * I2V_SWEEP_CUT["inference_steps"]:
        raise AssertionError(f"{tag}: controlnet passes on {rows} rows, not 2 in extraction "
                             f"and 4 in every step")
    args = next(a for n, a in passes if n == 4 and a is not None)
    cnet = rt.pipeline.controlnet
    with torch.no_grad():
        down, mid = cnet(*args[1:], impl="fused")
        unit_down, unit_mid = cnet(*args[1:6], torch.ones_like(args[6]), impl="fused")
    scales = args[6].float().flatten().tolist()
    if scales != [float(torch.tensor(x, dtype=torch.bfloat16)) for x in I2V_SWEEP_SCALES * 2]:
        raise AssertionError(f"{tag}: the CFG pair's scales are {scales}")
    worst = 0.0
    for r, u in zip(down + (mid,), unit_down + (unit_mid,)):
        if not bool(torch.isfinite(r.float()).all()) or not float(r.abs().max()) > 0:
            raise AssertionError(f"{tag}: a residual is non-finite or zero")
        for row, scale in enumerate(scales):
            want = u[row].float() * scale
            worst = max(worst, ((r[row].float() - want).abs().max()
                                / want.abs().max().clamp_min(1e-30)).item())
    log(f"{tag}: {len(rows)} controlnet passes (2 rows in extraction, 4 per step); each "
        f"example's residuals are its own scale times the unit-scale residuals within "
        f"{worst:.2e} of their largest (tol 1e-02, one bf16 rounding)")
    if worst > 1e-2:
        raise AssertionError(f"{tag}: residuals off their example's scale by {worst}")
    check_videos(tag, d["paths"], [sweep_name(v, p, s, rt.infer_cfg.positive_prompt)
                                   for v, p, s in SWEEP_EXAMPLES], stubbed, root, "out_10d",
                 frames, side)
    log(f"{tag}: {d['seconds']:.1f} s, sampling {rt.timings['sample']:.2f} s, peak device "
        f"memory {d['peak_gb']:.2f} GB [{card}]")
    del d, rt, args, down, mid, unit_down, unit_mid, passes
    torch.cuda.empty_cache()

    # (e) the server: 3 jobs, the first alone, the other two as one batch
    jobs = [{"video_path": "reference.mp4", "new_prompt": "Relics on the seabed", "seed": 42},
            {"video_path": "reference_b.mp4", "new_prompt": "A lighthouse on a cliff at dusk",
             "seed": 7},
            {"video_path": "reference.mp4", "new_prompt": "A fox in the snow", "seed": 5}]
    before = set(threading.enumerate())
    servers = []
    argv_e = argv("out_10e", "reps_10e", t2v_cut) + ["--batch-max", "2", "--port", "0",
                                                     "--host", "127.0.0.1"]
    main = threading.Thread(target=cli.serve_main, kwargs=dict(argv=argv_e,
                                                              ready=servers.append))
    tag = "serve (e)"
    t0 = time.perf_counter()
    with Counting(sweep_mod, "run_sweep", lambda args: len(args[1])) as batches, \
            Counting(runner.MotionCloneRuntime, "run_example") as singles:
        main.start()
        try:
            while not servers and main.is_alive() and time.perf_counter() - t0 < 120:
                time.sleep(0.05)
            if not servers:
                raise AssertionError(f"{tag}: the server did not start")
            port = servers[0].port
            log(f"{tag}: listening on 127.0.0.1:{port} after {time.perf_counter() - t0:.1f} s; "
                f"{cut}")
            codes, ids = [], []
            for i, job in enumerate(jobs):
                code, body = http(port, "/generate", job)
                codes.append(code)
                ids.append(body["job_id"])
                if i == 0:  # the others queue behind it
                    wait_job(port, ids[0], ("running", "done", "failed"), 60)
            bad = http(port, "/generate", {"new_prompt": "no video"})
            recs = [wait_job(port, i, ("done", "failed"), 300) for i in ids]
            health, metrics = http(port, "/health")[1], http(port, "/metrics")[1]
        finally:
            if servers:
                servers[0].shutdown()
            main.join(timeout=60)
    served_s = time.perf_counter() - t0
    if main.is_alive() or servers[0]._worker.is_alive():
        raise AssertionError(f"{tag}: the server's threads did not stop")
    if codes != [202] * 3 or bad[0] != 400:
        raise AssertionError(f"{tag}: POST statuses {codes}, malformed {bad}")
    if [r["status"] for r in recs] != ["done"] * 3:
        raise AssertionError(f"{tag}: jobs ended {[(r['status'], r['error']) for r in recs]}")
    if batches != [2] or len(singles) != 1:
        raise AssertionError(f"{tag}: {len(singles)} lone jobs and batches of {batches}, not "
                             f"one lone job and one batch of 2")
    for rec, job in zip(recs, jobs):
        name = sweep_name(job["video_path"], job["new_prompt"], job["seed"],
                          cfg.positive_prompt)
        if rec["output_path"] != os.path.join(root, "out_10e", name):
            raise AssertionError(f"{tag}: a job wrote {rec['output_path']}, not {name}")
        check_video(tag, read_output([rec["output_path"]], stubbed), frames, side)
    if (health["queue_depth"], health["worker_alive"]) != (0, True) or \
            "motionclone_jobs_done 3" not in metrics or "motionclone_jobs_failed 0" not in metrics:
        raise AssertionError(f"{tag}: health {health}, metrics {metrics}")
    deadline = time.time() + 10
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    if set(threading.enumerate()) - before:
        raise AssertionError(f"{tag}: threads left running: {set(threading.enumerate()) - before}")
    log(f"{tag}: 3 jobs done (one alone, two as one batch), the malformed body answered 400, "
        f"/health and /metrics read, every thread joined; job seconds "
        f"{[round(r['seconds'], 1) for r in recs]}; {served_s:.1f} s with the load [{card}]")


# ---------------------------------------------------------------------------
# phase 11: the multi-device layouts through the CLIs under torchrun
# ---------------------------------------------------------------------------

# every run of phase 11 (and its unsharded references) cuts the schedule to
# 2 steps, 1 guided and 1 vanilla (full guidance weight): each gloo step of
# ranks sharing one card waits seconds on the host's collectives (on one
# H100 80GB HBM3, phase 11 took 504 s at 10 steps and 348-378 s at 4;
# PERF.md), and one step of each kind drives every sharded path
LAYOUT_CUT = {"inference_steps": 2, "guidance_steps": 1, "warm_up_steps": 1,
              "cool_up_steps": 1}
LAYOUT_SHARDS = 2  # --frame-shard of every run
# one controlnet pass per rank of a frame-sharded run: its motion modules
# gather their keys and values, so PREDICTED_CONTROLNET_LAUNCHES' 4 launches
# of kernel 7 and 4 of kernel 3 become 8 of kernel 3r (one attention block)
PREDICTED_SHARDED_CONTROLNET_LAUNCHES = {
    "fused_spatial_transformer": 4, "fused_resnet_block": 5, "flash_fwd": 3,
    "temporal_fwd_rect": 8,
}
LAYOUT_RUN_TIMEOUT_S = 400.0


def predicted_layout_launches(guided: int, vanilla: int, extraction: bool, controlnet: bool,
                              half=None) -> dict:
    """One rank's launches in a frame-sharded CLI run at the exact schedule
    (``guided`` + ``vanilla`` steps) from PREDICTED_SHARDED_LAUNCHES:
    extraction where it ran, and per step the controlnet pass (i2v) and the
    rank's passes.  ``half``: None where the rank runs both CFG halves, 0
    or 1 its half under --cfg-pair (the unconditional half runs one plain
    forward per guided step, the conditional half the guidance pass; each
    half a plain forward per vanilla step: a pass launches alike at batch
    1 and 2)."""
    out = {}
    for name, (ext, per_g, per_v) in PREDICTED_SHARDED_LAUNCHES.items():
        cn = PREDICTED_SHARDED_CONTROLNET_LAUNCHES.get(name, 0) if controlnet else 0
        step = {None: per_g, 0: per_v, 1: per_g - per_v}[half]
        out[name] = ((ext + cn) if extraction else 0) + guided * (cn + step) \
            + vanilla * (cn + per_v)
    return out


def layout_rank_main(kinds: list, result_dir: str, argvs: list, entered_at: float) -> int:
    """One rank of a phase-11 torchrun call (``chip_smoke.py --layout-rank
    KIND[,KIND...] --result-dir DIR -- ARGV [-- ARGV ...]``): each CLI
    ``kinds[i]`` (t2v, i2v, sweep or serve) on ``argvs[i]`` in turn, with
    every launch count set to 0 just before and read just after; writes the
    rank's counts, gathered latents, timings, memory and wall-clock marks
    (``entered_at``: the script's code reached, its imports done) to
    DIR/run<i>_rank<r>.pt.  The first CLI joins the world from torchrun's
    variables as a user's run does; its ``Layout.close`` waits until the
    call's last CLI has run, so the later ones build their layouts on the
    same world."""
    from motionclone_tpu_torch import cli
    from motionclone_tpu_torch.parallel import frames
    from motionclone_tpu_torch.pipeline import runner
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    stubbed = stub_codec(reference_clip(16, 512))
    wrappers = kernel_wrappers()
    gathered, runtimes, layouts = [], [], []
    gather, setup, close = MotionClonePipeline.gather_latents, cli._setup, frames.Layout.close

    def spy_gather(self, latents):
        out = gather(self, latents)
        gathered.append(out.float().cpu())
        return out

    def spy_setup(*args, **kwargs):
        runtimes.append(setup(*args, **kwargs))
        return runtimes[-1]

    MotionClonePipeline.gather_latents, cli._setup = spy_gather, spy_setup
    frames.Layout.close = lambda self: layouts.append(self)
    # seconds of the runtime's set-up by step (the rank's load)
    spans = defaultdict(float)

    def span(name, fn):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans[name] += time.perf_counter() - t
        return timed

    frames.Layout.from_env = staticmethod(span("layout", frames.Layout.from_env))
    frames.FrameGroup.barrier = span("barriers", frames.FrameGroup.barrier)
    runner.load_params = span("cache read", runner.load_params)
    runner.load_into = span("modules", runner.load_into)
    MotionClonePipeline.__init__ = span("pipeline", MotionClonePipeline.__init__)
    for i, (kind, argv) in enumerate(zip(kinds, argvs)):
        for w in wrappers.values():
            w.launches = 0
        for held in (gathered, spans) + (() if stubbed is None else (stubbed,)):
            held.clear()
        torch.cuda.reset_peak_memory_stats()
        t0, cli_started_at = time.perf_counter(), time.time()
        served = None
        if kind == "serve":
            with open(os.path.join(result_dir, "job.json")) as fh:
                served = serve_one_job(cli, argv, json.load(fh)) if rank == 0 else \
                    cli.serve_main(argv)
            paths = [] if served is None else [served["record"]["output_path"]]
        else:
            main = {"t2v": cli.t2v_main, "i2v": cli.i2v_main, "sweep": cli.sweep_main}[kind]
            _, paths = main(argv)
        torch.cuda.synchronize()
        seconds, cli_ended_at = time.perf_counter() - t0, time.time()
        rt = runtimes[-1]
        layout = rt.layout
        torch.save(dict(
            rank=rank, launches={n: w.launches for n, w in wrappers.items()},
            latents=list(gathered), paths=paths, seconds=seconds,
            load_seconds=rt.load_seconds, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            timings=dict(rt.timings), half=None if layout.pair is None else layout.pair.rank,
            data_index=layout.data_index, lead=layout.is_lead, served=served,
            written=dict(stubbed) if stubbed is not None and layout.is_lead else None,
            entered_at=entered_at, cli_started_at=cli_started_at, cli_ended_at=cli_ended_at,
            spans=dict(spans), cache=rt.weights_cache_state,
        ), os.path.join(result_dir, f"run{i}_rank{rank}.pt"))
        del rt, layout
        runtimes.clear()  # the next CLI loads its own models
    for layout in layouts:  # the first CLI's closes the world
        close(layout)
    return 0


def serve_one_job(cli, argv: list, job: dict) -> dict:
    """Rank 0 of phase 11(e): ``cli.serve_main`` in a thread, ``job``
    POSTed to it, its record once done, then the server stopped and the
    thread joined."""
    import threading

    servers = []
    main = threading.Thread(target=cli.serve_main, kwargs=dict(argv=argv, ready=servers.append))
    main.start()
    t0 = time.perf_counter()
    while not servers and main.is_alive() and time.perf_counter() - t0 < 120:
        time.sleep(0.05)
    if not servers:
        raise AssertionError("serve (e): the server did not start")
    try:
        code, body = http(servers[0].port, "/generate", job)
        if code != 202:
            raise AssertionError(f"serve (e): POST answered {code} {body}")
        record = wait_job(servers[0].port, body["job_id"], ("done", "failed"), 300)
    finally:
        servers[0].shutdown()
        main.join(timeout=60)
    return {"record": record, "joined": not main.is_alive()}


def run_layouts(tag: str, runs: list, ranks: int, root: str, card: str, job=None) -> list:
    """The CLIs of ``runs`` ((kind, argv) pairs), in turn, in one call of
    ``python3 -m torch.distributed.run --standalone --nproc-per-node
    ranks``, each rank this script in ``--layout-rank`` mode (a torchrun
    start costs seconds of imports); returns each run's results, every
    rank's in rank order.  Raises with the output's end if torchrun fails
    or outlives LAYOUT_RUN_TIMEOUT_S, or if a process of the call is left."""
    import signal

    out = os.path.join(root, "ranks_" + "".join(c for c in tag if c.isalnum()))
    os.makedirs(out)
    if job is not None:
        with open(os.path.join(out, "job.json"), "w") as fh:
            json.dump(job, fh)
    here = os.path.abspath(__file__)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(ranks), here, "--layout-rank", ",".join(kind for kind, _ in runs),
           "--result-dir", out]
    for _, argv in runs:
        cmd += ["--"] + argv
    logpath = os.path.join(out, "log.txt")
    t0, launched_at = time.perf_counter(), time.time()
    with open(logpath, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(here), start_new_session=True)
        try:
            code = proc.wait(timeout=LAYOUT_RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            code = "killed at the time limit"
    seconds, exited_at = time.perf_counter() - t0, time.time()
    with open(logpath) as fh:
        text = fh.read()
    left = [cmd for _, cmd in descendants() if "--layout-rank" in cmd]
    if code != 0 or left:
        raise AssertionError(f"{tag}: torchrun exited {code} after {seconds:.1f} s; processes "
                             f"left: {left}\n{text[-8000:]}")
    for line in text.splitlines():
        if line.startswith(("[reference", "[sweep")) or line.endswith("is done"):
            log(f"  {tag} | {line}")
    results = [[torch.load(os.path.join(out, f"run{i}_rank{r}.pt"), weights_only=False)
                for r in range(ranks)] for i in range(len(runs))]
    mark = lambda key, pick, res: pick(r[key] for r in res) - launched_at
    spans = ", ".join(f"{kind} {mark('cli_started_at', min, res):.1f}-"
                      f"{mark('cli_ended_at', max, res):.1f} s"
                      for (kind, _), res in zip(runs, results))
    log(f"{tag}: {ranks} ranks, {seconds:.1f} s of torchrun [{card}]: every rank's code "
        f"reached (torchrun, interpreter, imports) at {mark('entered_at', max, results[0]):.1f}"
        f" s; the CLIs {spans}; torchrun's exit "
        f"{exited_at - launched_at - mark('cli_ended_at', max, results[-1]):.1f} s later")
    return results


def check_layout_run(tag: str, results: list, refs: list, control: float, controlnet: bool,
                     root: str, out: str, names: list, stubbed) -> list:
    """Phase 11's checks of one CLI run: each rank's launches against
    ``predicted_layout_launches`` (3r at least once); every rank of a video
    gathered the same latents, within SHARD_TOLS of the unsharded run at the
    same cut (``refs``: one per data group's example), printed beside phase
    3's rounding control; one 16 x 512 x 512 x 3 uint8 video per example,
    not constant, under the reference's name.  Returns each data group's
    latents."""
    g = LAYOUT_CUT["guidance_steps"]
    v = LAYOUT_CUT["inference_steps"] - g
    faults, median = [], (lambda ms: sorted(ms)[len(ms) // 2] if ms else float("nan"))
    for res in results:
        r, t = res["rank"], res["timings"]
        want = predicted_layout_launches(g, v, "extract" in t, controlnet, res["half"])
        differs = [f"{n} {res['launches'][n]}/{want[n]}" for n in want
                   if res["launches"][n] != want[n]]
        if differs or res["launches"]["temporal_fwd_rect"] < 1:
            faults.append(f"rank {r} launches (measured/predicted) {differs}")
        log(f"{tag} rank {r} (data group {res['data_index']}, "
            f"{'both CFG halves' if res['half'] is None else ('uncond', 'cond')[res['half']] + ' half'}): "
            f"launches {'as predicted' if not differs else 'DIFFER: ' + ', '.join(differs)} "
            f"(3r {res['launches']['temporal_fwd_rect']}, 4r "
            f"{res['launches']['temporal_bwd_rect']}, extraction "
            f"{'ran' if 'extract' in t else 'cached'}); load {res['load_seconds']:.1f} s "
            f"(weights cache {res['cache']}; "
            + ", ".join(f"{k} {v:.2f} s" for k, v in res["spans"].items()) + "), CLI "
            f"{res['seconds']:.1f} s, text {t.get('text', 0.0):.2f} s, extraction "
            f"{t.get('extract', 0.0):.2f} s, decode + write {t.get('decode_write', 0.0):.2f} s, "
            f"sampling {t['sample']:.2f} s, ms per guided step median "
            f"{median(t['guided_ms']):.1f}, per vanilla step {median(t['vanilla_ms']):.1f}; "
            f"peak {res['peak_gb']:.2f} GB")
    latents = {}
    for res in results:
        got = res["latents"][-1]
        first = latents.setdefault(res["data_index"], got)
        if not torch.equal(got, first):
            faults.append(f"rank {res['rank']} gathered other latents than its video's lead")
    for d, got in sorted(latents.items()):
        rel = rel_l2(got, refs[d])
        ok = rel <= SHARD_TOLS["latents_rel_l2"]
        log(f"{tag} example {d + 1} against the unsharded CLI run at the same cut: final "
            f"latents relative L2 {rel:.4e} (tol {SHARD_TOLS['latents_rel_l2']:g}) "
            f"{'OK' if ok else 'FAIL'}; phase 3's bf16 rounding control {control:.4e}")
        if not ok:
            faults.append(f"example {d + 1} latents relative L2 {rel}")
    if faults:
        raise AssertionError(f"{tag}: " + "; ".join(faults))
    written = {}
    for res in results:
        written.update(res["written"] or {})
    paths = sorted(p for res in results if res["lead"] for p in res["paths"])
    want_paths = sorted(os.path.join(root, out, n) for n in names)
    mp4s = sorted(os.path.join(root, out, n) for n in os.listdir(os.path.join(root, out))
                  if n.endswith(".mp4")) if stubbed is None else sorted(written)
    if paths != want_paths or mp4s != want_paths:
        raise AssertionError(f"{tag}: wrote {mp4s} (leads report {paths}), not {want_paths}")
    for path in paths:
        check_video(tag, read_output([path], written if stubbed is not None else None), 16, 512)
    return [latents[d] for d in sorted(latents)]


def layouts_cli(dev, wrappers, card: str, root: str, reference: dict, backend: str) -> None:
    """Phase 11: the CLIs under torchrun at --frame-shard 2 on phases 7-10's
    model directory in ``root`` (written here where it is not there, as
    under --sharded-only), schedules cut to LAYOUT_CUT: (a) t2v (2 ranks),
    (b) t2v with --cfg-pair (4), (c) i2v_rgb (2; the controlnet's 3r), (d)
    the sweep of 2 examples (4: data 2), (e) the server with one job (2),
    each against the unsharded CLI run at the same cut, (e) against (a);
    (a), (c) and (e) in one torchrun call, (b) and (d) in another."""
    import shutil

    from motionclone_tpu_torch import cli

    side, frames = 512, 16
    clip = reference_clip(frames, side)
    stubbed = stub_codec(clip)
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(root, "t2v.yaml")):
        saved = write_model_dir(root, dev, sd15_configs())
        if stubbed is None:
            from motionclone_tpu_torch.io import video as video_io

            video_io.write_video(os.path.join(root, "reference.mp4"), clip, fps=8)
        write_adapter_lora(root, saved["unet"])
        write_controlnet(root, dev, sd15_configs()[0], "rgb")
        if stubbed is None:
            write_png(os.path.join(root, "condition.png"), clip[0])
        write_i2v_config(root, "rgb")
        del saved
        torch.cuda.empty_cache()
        log(f"layouts: model directory written in {time.perf_counter() - t0:.1f} s")
    if stubbed is None and not os.path.exists(os.path.join(root, "reference_b.mp4")):
        shutil.copy(os.path.join(root, "reference.mp4"), os.path.join(root, "reference_b.mp4"))
    t2v_cut = write_cut_yaml(os.path.join(root, "t2v.yaml"),
                             os.path.join(root, "t2v_layout.yaml"), LAYOUT_CUT)
    i2v_cut = write_cut_yaml(os.path.join(root, "i2v_rgb.yaml"),
                             os.path.join(root, "i2v_rgb_layout.yaml"), LAYOUT_CUT)
    examples = [{"video_path": v, "new_prompt": p, "seed": s} for v, p, s in SWEEP_EXAMPLES]
    ex = {"one": write_examples(os.path.join(root, "examples_11.jsonl"), examples[:1]),
          "second": write_examples(os.path.join(root, "examples_11b.jsonl"), examples[1:]),
          "sweep": write_examples(os.path.join(root, "examples_11d.jsonl"), examples),
          "i2v": write_examples(os.path.join(root, "examples_11c.jsonl"), [
              {"video_path": "reference.mp4", "new_prompt": I2V_PROMPTS["rgb"],
               "condition_image_paths": ["condition.png"], "image_index": [0]}])}
    wc = os.path.join(root, "weights_cache")

    def argv(out, reps, cfg=t2v_cut, examples=ex["one"], i2v=False):
        base = (i2v_argv(root, "rgb", dev, out) if i2v else t2v_argv(root, dev, out))
        return base + ["--inference_config", cfg, "--examples", examples, "--weights-cache", wc,
                       "--motion-representation-save-dir", os.path.join(root, reps)]

    layout = ["--frame-shard", str(LAYOUT_SHARDS), "--dist-backend", backend] + (
        ["--device", "cuda:0"] if backend == "gloo" else ["--device", "cuda"])
    where = ("ranks sharing card 0 over gloo, every gather staged through host memory: no "
             "speed figure" if backend == "gloo" else "one card per rank over nccl")
    cut = (f"schedules cut from configs/t2v_camera.yaml's 100 steps (50 guided) and "
           f"configs/i2v_rgb.yaml's 100 (40 guided) to {LAYOUT_CUT['inference_steps']} "
           f"({LAYOUT_CUT['guidance_steps']} guided, warm-up and cool-down "
           f"{LAYOUT_CUT['warm_up_steps']})")
    log(f"layouts: --frame-shard {LAYOUT_SHARDS} through the CLIs under torchrun, {where}; "
        f"{cut}")
    # the unsharded CLI runs at the same cut, in this process
    refs = {}
    for key, main, args in (
            ("t2v", cli.t2v_main, argv("out_11_ref", "reps_11_ref")),
            ("second", cli.t2v_main, argv("out_11_ref", "reps_11_ref", examples=ex["second"])),
            ("i2v", cli.i2v_main, argv("out_11_ref_i2v", "reps_11_ref_i2v", i2v_cut,
                                       ex["i2v"], True))):
        run = run_cli(main, args, wrappers)
        refs[key] = run["latents"]
        log(f"layouts: unsharded {key} run at the cut {run['seconds']:.1f} s, sampling "
            f"{run['rt'].timings['sample']:.2f} s, peak {run['peak_gb']:.2f} GB [{card}]")
        del run
        torch.cuda.empty_cache()
    control = deviations(reference["control"], reference)["latents_rel_l2"]
    names = [sweep_name(v, p, s, positive_prompt(t2v_cut)) for v, p, s in SWEEP_EXAMPLES]
    t2v_name = names[0]
    i2v_name = sweep_name("reference.mp4", I2V_PROMPTS["rgb"], 76739, positive_prompt(i2v_cut))

    # two torchrun calls, one per world size, each CLI of a call on the world
    # its first one joins: (a), (c), (e) on 2 ranks, then (b), (d) on 4
    # (they reuse (a)'s motion representation)
    ace = run_layouts("(a, c, e)", [
        ("t2v", argv("out_11a", "reps_11a") + layout),
        ("i2v", argv("out_11c", "reps_11c", i2v_cut, ex["i2v"], True) + layout),
        ("serve", argv("out_11e", "reps_11a") + layout + ["--port", "0", "--batch-max", "2"])],
        2, root, card, job=examples[0])
    bd = run_layouts("(b, d)", [
        ("t2v", argv("out_11b", "reps_11a") + layout + ["--cfg-pair"]),
        ("sweep", argv("out_11d", "reps_11a", examples=ex["sweep"]) + layout
         + ["--num-devices", "1"])], 4, root, card)
    a = check_layout_run("(a) t2v --frame-shard 2", ace[0], [refs["t2v"]], control, False,
                         root, "out_11a", [t2v_name], stubbed)
    check_layout_run("(b) t2v --frame-shard 2 --cfg-pair", bd[0], [refs["t2v"]], control,
                     False, root, "out_11b", [t2v_name], stubbed)
    check_layout_run("(c) i2v_rgb --frame-shard 2", ace[1], [refs["i2v"]], control, True, root,
                     "out_11c", [i2v_name], stubbed)
    check_layout_run("(d) sweep --frame-shard 2, data 2", bd[1], [refs["t2v"], refs["second"]],
                     control, False, root, "out_11d", names, stubbed)
    served = ace[2][0]["served"]
    if served["record"]["status"] != "done" or not served["joined"]:
        raise AssertionError(f"serve (e): {served}")
    e = check_layout_run("(e) serve --frame-shard 2, one job", ace[2], [refs["t2v"]], control,
                         False, root, "out_11e", [t2v_name], stubbed)
    log(f"(e) serve: the job done in {served['record']['seconds']:.1f} s, the server stopped "
        f"and its thread joined on rank 0, the other rank's loop ended")
    same_or_close("(e) serve's latents against (a)'s", e[0], a[0])


def positive_prompt(path: str) -> str:
    """The positive prompt of a workload YAML (it enters the mp4 names)."""
    from motionclone_tpu_torch.config import load_inference_config

    return load_inference_config(path).positive_prompt


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 12: plain generation, its probability dump and the parity harness
# ---------------------------------------------------------------------------

# phase 12 (c): phase 8's i2v_rgb video regenerated by run_parity, scored
# against itself on disk
PARITY_LIMITS = {"psnr_mean": 40.0, "ssim_mean": 0.99}


def predicted_probs_launches(pipe, steps: int) -> dict:
    """The launches of ``steps`` plain steps that dump the probabilities
    (``sample_plain_probs``): a vanilla step's each, less what the guidance
    blocks' motion modules launch on their own route at the CFG pair's
    shape, from ``fused_route`` (the shapes alone): kernel 7, or kernel 3
    once per attention block; each takes the plain probability route
    instead, which launches no kernel."""
    from motionclone_tpu_torch.models.unet_blocks import match_guidance

    cfg = pipe.infer_cfg
    guidance = tuple(cfg.motion_guidance_blocks)
    out = {name: per_v * steps for name, (_, _, per_v) in PREDICTED_LAUNCHES.items()}
    levels = len(pipe.unet_cfg.block_out_channels)
    for i, block in enumerate(pipe.unet.up_blocks):
        side = (cfg.height // 8) >> (levels - 1 - i)  # up block i's input side
        for j, mm in enumerate(block.motion_modules or ()):
            if not match_guidance(f"up_blocks.{i}.motion_modules.{j}", guidance):
                continue
            tt = mm.temporal_transformer
            shape = (2, cfg.video_length, side, side, block.resnets[j].conv1.out_channels)
            if tt.fused_route(shape, "cuda"):
                out["fused_temporal_module"] -= steps
            else:
                out["temporal_fwd"] -= steps * len(tt.transformer_blocks[0].attention_blocks)
    return out


def compare_launches(tag: str, launches: dict, want: dict) -> None:
    differs = [name for name in want if launches[name] != want[name]]
    for name in want:
        log(f"{tag} launches {name:25s} measured {launches[name]:5d} predicted "
            f"{want[name]:5d}{'  DIFFERS' if name in differs else ''}")
    if differs:
        raise AssertionError(f"{tag}: launches differ from the prediction: {differs}")


def plain_path(dev, wrappers, card: str, root: str) -> dict:
    """Phase 12 on phase 3's pipeline (its seeded weights and token ids)
    and phases 7-8's model directory in ``root``: (a)
    ``sample_latents_plain`` at the full t2v_camera plain schedule, (b) its
    ``save_probs_path`` dump at phase 3's 4-step cut against the undumped
    run, (c) ``run_parity`` on phase 8's i2v_rgb example against phase 8's
    video.  Returns (a)'s launches."""
    import shutil

    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline
    from motionclone_tpu_torch.pipeline.parity import run_parity

    t0 = time.perf_counter()
    pipe, ids, _ = build_pipeline(dev)
    emb = pipe.encode_text(ids)
    uncond, cond = emb[:1], emb[1:]
    full_cfg = t2v_config(inference_steps=100, guidance_steps=50, warm_up_steps=10,
                          cool_up_steps=10)
    full = MotionClonePipeline(pipe.unet_cfg, pipe.sched_cfg, full_cfg, pipe.unet,
                               device=dev, dtype=pipe.dtype)
    n = len(full.fns.plain_timesteps)
    log(f"plain: phase 3's pipeline set up in {time.perf_counter() - t0:.1f} s")

    # (a) the full plain schedule
    for w in wrappers.values():
        w.launches = 0
    marks = []

    def on_step(i, guided):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = full.sample_latents_plain(uncond, cond, seed=3, on_step=on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = sorted(a.elapsed_time(b) for a, b in zip([start] + marks[:-1], marks))
    shape = (1, full_cfg.video_length, full_cfg.height // 8, full_cfg.width // 8,
             pipe.unet_cfg.in_channels)
    if len(ms) != n or tuple(out.shape) != shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"plain (a): {len(ms)} steps, latents {tuple(out.shape)} (want "
                             f"{shape}) or non-finite values")
    compare_launches("plain (a)", launches, predicted_launches(
        full.fns.schedule(plain=True), 0, False, False))
    log(f"plain (a): sample_latents_plain, configs/t2v_camera.yaml's {n} steps on the "
        f"\"leading\" schedule (t {full.fns.plain_timesteps[0]} .. "
        f"{full.fns.plain_timesteps[-1]}), {full_cfg.width}x{full_cfg.height}x"
        f"{full_cfg.video_length}, {str(pipe.dtype)[6:]}, random weights: "
        f"{seconds:.2f} s, ms per step median {ms[len(ms) // 2]:.1f} (min {ms[0]:.1f}, "
        f"max {ms[-1]:.1f}), peak device memory {peak_gb:.2f} GB [{card}]")
    del full, out

    # (b) the save_probs dump at phase 3's cut, against the undumped run
    path = os.path.join(root, "plain_probs.npz")
    steps = len(pipe.fns.plain_timesteps)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dumped = pipe.sample_latents_plain(uncond, cond, seed=3, save_probs_path=path)
    torch.cuda.synchronize()
    dump_s = time.perf_counter() - t0
    compare_launches("plain (b) dump", {name: w.launches for name, w in wrappers.items()},
                     predicted_probs_launches(pipe, steps))
    undumped = pipe.sample_latents_plain(uncond, cond, seed=3)
    ucfg = pipe.unet_cfg
    n_rep = ((ucfg.layers_per_block + 1) * ucfg.motion_module.num_transformer_block
             * len(ucfg.motion_module.attention_block_types))
    with np.load(path) as d:
        probs = {k: d[k] for k in d.files}
    host_bytes = sum(v.nbytes for v in probs.values())
    worst = max(float(np.abs(v.sum(-1) - 1.0).max()) for v in probs.values())
    if len(probs) != n_rep or any(v.shape[:2] != (steps, 2) or v.dtype != np.float32
                                  or not np.isfinite(v).all() for v in probs.values()):
        raise AssertionError(f"plain (b): the dump holds {len(probs)} maps (want {n_rep}) "
                             f"of {sorted({v.shape for v in probs.values()})}")
    dev_l2 = rel_l2(dumped, undumped)
    log(f"plain (b): save_probs_path at phase 3's cut ({steps} steps): {len(probs)} maps of "
        f"{next(iter(probs.values())).shape} float32, {host_bytes} bytes on the host "
        f"({os.path.getsize(path)} in the file), in {dump_s:.2f} s; rows sum to 1 within "
        f"{worst:.2e} (limit 1e-3); latents against the undumped run: relative L2 "
        f"{dev_l2:.3e} (limit {RERUN_TOL:.0e}; the dumped modules take the plain "
        f"probability route) [{card}]")
    if worst > 1e-3 or dev_l2 > RERUN_TOL:
        raise AssertionError(f"plain (b): row sums off by {worst}, latents by {dev_l2}")
    del pipe, dumped, undumped, probs
    torch.cuda.empty_cache()

    # (c) run_parity on phase 8's i2v_rgb example, scored against phase 8's video
    reference = os.path.join(root, "out_rgb")
    if not any(f.endswith(".mp4") for f in os.listdir(reference)):
        raise AssertionError("plain (c) scores files on disk: phase 8 wrote no mp4 (cv2 "
                             "absent?)")
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    shutil.copy(os.path.join(root, "i2v_rgb.yaml"), os.path.join(root, "configs",
                                                                 "i2v_rgb.yaml"))
    shutil.copy(os.path.join(root, "examples_rgb.jsonl"),
                os.path.join(root, "configs", "i2v_rgb.jsonl"))
    t0 = time.perf_counter()
    summary = run_parity(reference, os.path.join(root, "parity_out"), config_root=root,
                         pretrained_model_path=os.path.join(root, "sd"), workloads=("rgb",),
                         device=str(dev), verbose=False)
    parity_s = time.perf_counter() - t0
    log(f"plain (c): run_parity(workloads=('rgb',)) against phase 8's video in "
        f"{parity_s:.1f} s: {json.dumps(summary)} [{card}]")
    if (summary["generated"], summary["matched"]) != (1, 1) or any(
            summary[k] < limit for k, limit in PARITY_LIMITS.items()):
        raise AssertionError(f"plain (c): {summary} (limits {PARITY_LIMITS})")
    torch.cuda.empty_cache()
    return launches


KERNELS = {
    "flash_fwd": ("motionclone_tpu_torch/csrc/flash_attention.cu",
                  "motionclone_tpu/ops/flash_attention.py:204"),
    "flash_bwd": ("motionclone_tpu_torch/csrc/flash_attention.cu",
                  "motionclone_tpu/ops/flash_attention.py:443"),
    "temporal_fwd": ("motionclone_tpu_torch/csrc/temporal_attention.cu",
                     "motionclone_tpu/ops/temporal_attention.py:147"),
    "temporal_bwd": ("motionclone_tpu_torch/csrc/temporal_attention.cu",
                     "motionclone_tpu/ops/temporal_attention.py:172"),
    "fused_spatial_transformer": ("motionclone_tpu_torch/csrc/fused_block.cu",
                                  "motionclone_tpu/ops/fused_block.py:306"),
    "fused_transformer_block": ("motionclone_tpu_torch/csrc/fused_block.cu",
                                "motionclone_tpu/ops/fused_block.py:387"),
    "fused_temporal_module": ("motionclone_tpu_torch/csrc/fused_temporal.cu",
                              "motionclone_tpu/ops/fused_temporal.py:171"),
    "fused_resnet_block": ("motionclone_tpu_torch/csrc/fused_resnet.cu",
                           "motionclone_tpu/ops/fused_resnet.py:200"),
    "temporal_fwd_rect": ("motionclone_tpu_torch/csrc/temporal_attention.cu",
                          "motionclone_tpu/ops/temporal_attention.py:147"),
    "temporal_bwd_rect": ("motionclone_tpu_torch/csrc/temporal_attention.cu",
                          "motionclone_tpu/ops/temporal_attention.py:172"),
}


def log_flash_resources(build_log: str, lib) -> None:
    """Registers per thread (ptxas) and dynamic shared memory per block of
    the flash kernels (kernels 1 and 2) at each head dim."""
    import re

    smem_of = {"flash_fwd_kernel": 0, "flash_bwd_dq_kernel": 1, "flash_bwd_dkv_kernel": 2}
    section, name = "", None
    for line in build_log.splitlines():
        if line.startswith("== "):
            section = line[3:].strip()
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)ILi(\d+)ELi(\d+)E", line)
        if m and "Compiling entry function" in line:
            name = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name and section == "flash_attention.cu":
            kernel, d, tile = name
            log(f"  flash resources {kernel}<D={d}, tile={tile}>: {m.group(1)} registers, "
                f"{lib.mc_flash_smem(int(d), smem_of[kernel])} bytes shared memory")
            name = None


def log_product_resources(build_log: str, lib) -> None:
    """Registers per thread, spills (ptxas) and dynamic shared memory per
    block of each instantiation of the TMA + wgmma product (kernels 5-7's
    linear layers, kernel 8's shortcut and its convolutions), in each
    source that includes it."""
    import re

    section, name, spills = "", None, "spills not reported"
    for line in build_log.splitlines():
        if line.startswith("== "):
            section = line[3:].strip()
        m = re.search(r"product_kernelILi(\d)ELb([01])ELb([01])ELb([01])E", line)
        if m and "Compiling entry function" in line:
            res, out, geglu, conv = m.groups()
            name = (f"{'conv3x3, ' if conv == '1' else ''}"
                    f"residual {('none', 'bf16', 'f32')[int(res)]}, "
                    f"out {('bf16', 'f32')[int(out)]}{', GEGLU' if geglu == '1' else ''}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            log(f"  product resources {section} product_kernel<{name}>: {m.group(1)} "
                f"registers (at launch; setmaxnreg 40 producer / 232 consumers), {spills}, "
                f"{lib.mc_fused_product_smem(int(out == '1'))} bytes shared memory")
            name = None


def log_temporal_resources(build_log: str, lib) -> None:
    """Registers per thread, spills (ptxas), warps and dynamic shared memory
    per block of each instantiation of the temporal attention kernel
    (kernels 3, 4, 3r and 4r) in temporal_attention.cu; kernel 7's source,
    fused_temporal.cu, compiles the same forwards."""
    import re

    from motionclone_tpu_torch.ops import temporal_attention as ta

    section, name, spills = "", None, "spills not reported"
    for line in build_log.splitlines():
        if line.startswith("== "):
            section = line[3:].strip()
        m = re.search(r"temporal_kernelILi(\d+)ELi(\d+)ELb([01])E", line)
        if m and "Compiling entry function" in line and section == "temporal_attention.cu":
            name = m.groups()
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            d, fq, bwd = name
            smem = lib.mc_temporal_smem(int(d), int(fq), int(bwd))
            warps = ta.warps_per_block(int(d), int(fq), bwd == "1")
            log(f"  temporal resources {section} {'bwd' if bwd == '1' else 'fwd'}"
                f"<D={d}, FQ={fq}>: {m.group(1)} registers, {spills}, {warps} warps and "
                f"{smem} bytes shared memory per block")
            name, spills = None, "spills not reported"


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches."""
    from motionclone_tpu_torch.ops import flash_attention as fa
    from motionclone_tpu_torch.ops import fused_block as fb
    from motionclone_tpu_torch.ops import fused_resnet as fr
    from motionclone_tpu_torch.ops import fused_temporal as ft
    from motionclone_tpu_torch.ops import temporal_attention as ta

    return {"flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
            "temporal_fwd": ta.temporal_fwd, "temporal_bwd": ta.temporal_bwd,
            "fused_spatial_transformer": fb.fused_spatial_transformer_kernel,
            "fused_transformer_block": fb.fused_transformer_block_kernel,
            "fused_temporal_module": ft.fused_temporal_kernel,
            "fused_resnet_block": fr.fused_resnet_kernel,
            "temporal_fwd_rect": ta.temporal_fwd_rect,
            "temporal_bwd_rect": ta.temporal_bwd_rect}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile one guided and one vanilla step, "
                             "writing chrome traces to DIR (phase 5)")
    parser.add_argument("--shards", type=int, default=2,
                        help="frame shards of phase 6 (default 2)")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                        help="phases 6 and 11's backend: gloo puts every rank on card 0, "
                             "nccl rank r on card r (default gloo)")
    parser.add_argument("--sharded-only", action="store_true",
                        help="run phases 0, 1, 6 and 11 only, with the unsharded run "
                             "phases 6 and 11 compare with")
    args = parser.parse_args()
    # phase 0: device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from motionclone_tpu_torch.ops import build as kbuild

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
        log_flash_resources(kbuild.build_info["log"], kbuild.load_library())
        log_product_resources(kbuild.build_info["log"], kbuild.load_library())
        log_temporal_resources(kbuild.build_info["log"], kbuild.load_library())

    wrappers = kernel_wrappers()
    if args.sharded_only:
        pipe, ids, video = build_pipeline(dev)
        reference = unsharded_reference(pipe, ids, video, wrappers,
                                        drive(pipe, ids, video, wrappers))
        del pipe
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sharded_path(dev, reference, args.shards, args.backend)
        log(f"phase sharded path: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        import tempfile

        with tempfile.TemporaryDirectory(prefix="cli_") as root:
            t0 = time.perf_counter()
            layouts_cli(dev, wrappers, card, root, reference, args.backend)
            log(f"phase layouts: {time.perf_counter() - t0:.1f} s")
        return finish(card)

    # phase 2: kernels against their plain versions
    t0 = time.perf_counter()
    check_products(dev)
    check_convs(dev)
    rows = check_kernels(dev)
    rows.update(check_fused_kernels(dev))
    rows.update(check_resnet_kernels(dev))
    check_xl_kernels(dev)
    check_controlnet_temporal(dev)
    check_group_norm(dev)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    # phase 3: the main path (with phase 6, the only windows the launch
    # counts cover)
    t0 = time.perf_counter()
    reference = main_path(dev, wrappers, args.profile)
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # phase 3b: SDXL's path, its launches and shapes
    t0 = time.perf_counter()
    xl_path(dev, wrappers)
    log(f"phase SDXL path: {time.perf_counter() - t0:.1f} s")
    # phase 4: the card against the CPU at a reduced depth
    t0 = time.perf_counter()
    reference_check(dev, wrappers)
    reference_check_i2v(dev, wrappers)
    log(f"phase reference: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # phase 6: the frame-sharded main path, against phase 3's run
    t0 = time.perf_counter()
    sharded = sharded_path(dev, reference, args.shards, args.backend)
    log(f"phase sharded path: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    import tempfile

    with tempfile.TemporaryDirectory(prefix="cli_") as root:
        # phase 7: the t2v CLI from a model directory on disk
        t0 = time.perf_counter()
        t2v = t2v_cli(dev, wrappers, card, root)
        log(f"phase t2v CLI: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        # phase 7b: the DreamBooth EMA weights and the image and motion LoRAs
        t0 = time.perf_counter()
        merged_weights(dev, wrappers, card, root, t2v["saved"])
        log(f"phase merged weights: {time.perf_counter() - t0:.1f} s")
        # phase 8: the i2v CLI, both SparseCtrl flavours
        t0 = time.perf_counter()
        i2v = i2v_cli(dev, wrappers, card, root, t2v["saved"])
        log(f"phase i2v CLI: {time.perf_counter() - t0:.1f} s")
        # phase 9: --approx, --weights-cache and --resume through the CLIs
        t0 = time.perf_counter()
        approx_cli(dev, wrappers, card, root, t2v, i2v)
        log(f"phase approx CLI: {time.perf_counter() - t0:.1f} s")
        del i2v
        torch.cuda.empty_cache()
        # phase 10: the sweep and the server
        t0 = time.perf_counter()
        sweep_cli(dev, wrappers, card, root, t2v)
        log(f"phase sweep and serve: {time.perf_counter() - t0:.1f} s")
        del t2v
        torch.cuda.empty_cache()
        # phase 11: the multi-device layouts through the CLIs under torchrun
        t0 = time.perf_counter()
        layouts_cli(dev, wrappers, card, root, reference, args.backend)
        log(f"phase layouts: {time.perf_counter() - t0:.1f} s")
        # phase 12: plain generation, its probability dump and the parity harness
        t0 = time.perf_counter()
        plain = plain_path(dev, wrappers, card, root)
        log(f"phase plain and parity: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        # the rectangular kernels' launches are one rank's on the sharded path
        launches = sharded if name.endswith("_rect") else reference["launches"]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            plain_launches=plain[name], **rows[name]))
    log(json.dumps({"kernels": kernels}))
    return finish(card)


def finish(card: str) -> int:
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--layout-rank"]:
        # one rank of a phase-11 run: --layout-rank KIND --result-dir DIR -- ARGV
        # one phase-11 call: --layout-rank KINDS --result-dir DIR -- ARGV [-- ARGV ...]
        argvs = [[]]
        for arg in sys.argv[6:]:
            argvs.append([]) if arg == "--" else argvs[-1].append(arg)
        sys.exit(layout_rank_main(sys.argv[2].split(","), sys.argv[4], argvs, time.time()))
    adopt_orphans()
    try:
        code = main()
    finally:
        stop_descendants()
    sys.exit(code)
