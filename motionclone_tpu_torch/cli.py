"""Command line of the port: ``python3 -m motionclone_tpu_torch.cli`` runs
:func:`t2v_main`, ``python3 -m motionclone_tpu_torch.i2v`` :func:`i2v_main`,
``python3 -m motionclone_tpu_torch.sweep`` :func:`sweep_main` and
``python3 -m motionclone_tpu_torch.serve`` :func:`serve_main`.

Port of the entry points of ``motionclone_tpu/cli.py``, with the same flags
and defaults and one more, ``--device`` (``cuda`` by default; ``cpu`` runs
the kernels' plain PyTorch versions).  ``--approx``
(the approx caches, :func:`parse_approx`), ``--resume`` (per-chunk resume
of sampling) and ``--weights-cache DIR`` (the converted-weights cache) work
as in the JAX package.

``--frame-shard N`` and ``--cfg-pair`` are the JAX package's multi-device
layouts, run under torchrun with one process per rank
(``parallel/frames.Layout``): t2v, i2v and the server take a world of N
ranks (2N with ``--cfg-pair``), the sweep any multiple of that, as data
groups that share nothing.  ``--dist-backend`` names the process group's
backend: ``nccl`` (the default; rank r on ``cuda:LOCAL_RANK``) or ``gloo``
(ranks on the CPU, or sharing one card: ``--device cuda:K`` keeps every
rank on card K); nothing switches it.  For example, on the CPU:

    torchrun --nproc-per-node 2 -m motionclone_tpu_torch.cli \\
        --frame-shard 2 --dist-backend gloo --device cpu ...

``--frame-shard-mode gspmd`` (the JAX package's GSPMD flavour) exits,
naming its ``ROADMAP.md`` list.  ``--attention-impl xla|chunked`` and
``--without-xformers`` select the port's unfused ("flash") path and say so;
``--visible_gpu`` and ``--compile-cache`` are accepted and print that they
do nothing.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

from motionclone_tpu_torch.config import InferenceConfig, load_examples, load_inference_config
from motionclone_tpu_torch.pipeline.runner import MotionCloneRuntime, check_layout_flags

# flag -> (its default, why the port refuses another value)
UNPORTED = {
    "frame_shard_mode": ("shardmap", "the GSPMD frame-sharding flavour is not ported "
                                     "(ROADMAP.md queue 1, 'Do not port')"),
}


def build_parser(default_config: str, default_examples: str,
                 default_seed: int = 2025) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="MotionClone (PyTorch port)")
    parser.add_argument("--pretrained-model-path", type=str, default="models/StableDiffusion")
    parser.add_argument("--inference_config", type=str, default=default_config)
    parser.add_argument("--examples", type=str, default=default_examples)
    parser.add_argument("--motion-representation-save-dir", type=str,
                        default="motion_representation/")
    parser.add_argument("--generated-videos-save-dir", type=str, default="generated_videos")
    parser.add_argument("--default-seed", type=int, default=default_seed)
    parser.add_argument("--L", type=int, default=16)
    parser.add_argument("--W", type=int, default=512)
    parser.add_argument("--H", type=int, default=512)
    parser.add_argument("--config-root", type=str, default=".")
    parser.add_argument("--float32", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the pipeline runs: cuda (default) or cpu")
    parser.add_argument("--visible_gpu", type=str, default=None,
                        help="accepted for compatibility; does nothing (select the "
                             "card with CUDA_VISIBLE_DEVICES or --device cuda:N)")
    parser.add_argument("--without-xformers", action="store_true",
                        help="alias of --attention-impl flash (the unfused path)")
    parser.add_argument("--attention-impl", type=str, default="auto",
                        choices=["auto", "xla", "chunked", "flash", "fused"],
                        help="auto: fused kernels on CUDA, unfused on the CPU; "
                             "flash: unfused (attention kernels only); fused; "
                             "xla and chunked select flash")
    parser.add_argument("--resume", action="store_true",
                        help="checkpoint the sampling loop's latents after each chunk "
                             "(in the output directory) and continue an interrupted run "
                             "from the last finished chunk")
    parser.add_argument(
        "--frame-shard", type=int, default=0, metavar="N",
        help="split the frame axis over N local devices (N must divide "
        "--L). t2v/i2v: single-video latency scaling; sweeps: composes "
        "with example data-parallelism over a (data, [cfg,] frames) mesh "
        "(examples per batch = devices / N / cfg). The port runs one "
        "process per device under torchrun --nproc-per-node")
    parser.add_argument("--frame-shard-mode", type=str, default="shardmap",
                        choices=["shardmap", "gspmd"],
                        help="shardmap (the port's only flavour: explicit temporal-attention "
                             "gathers, the fused kernels per rank); gspmd is not ported")
    parser.add_argument(
        "--cfg-pair", action="store_true",
        help="split each classifier-free-guidance pair over a 'cfg' mesh "
        "axis of size 2. With --frame-shard N: a composed (cfg, frames) "
        "mesh over 2N devices (single-video latency); in sweeps: a "
        "(data, cfg) mesh (best when chips outnumber examples)")
    parser.add_argument("--dist-backend", type=str, default="nccl", choices=["nccl", "gloo"],
                        help="the process group's backend under --frame-shard / --cfg-pair: "
                             "nccl (one card per rank, cuda:LOCAL_RANK) or gloo (ranks on "
                             "the CPU, or sharing one card with --device cuda:K)")
    parser.add_argument(
        "--approx", type=str, default="", metavar="MODE[:K]",
        help="OUTPUT-CHANGING speed mode; default is the exact pipeline. "
        "'uncond-cache[:K]': cross-step cache — refresh the unconditional "
        "UNet forward every K steps (default 3) and reuse the cached "
        "prediction in between (the conditional pass and motion guidance "
        "stay exact). 'guidance-cache[:K]': refresh the motion-guidance "
        "gradient (the cond fwd+bwd) every K guided steps (default 2); in "
        "between a plain conditional forward supplies the CFG term and the "
        "cached gradient is re-applied with the current ramp. "
        "'uncond-extrap[:K]': like uncond-cache but the cached prediction "
        "is linearly extrapolated in timestep space between refreshes. "
        "'step-cache[:K]': run the FULL step (controlnet + uncond + "
        "cond/grad) every K steps (default 2) and in between hold the cached "
        "combined noise prediction — only the DDIM update runs on skip "
        "steps. 'step-extrap[:K]': like step-cache but the held prediction "
        "is linearly extrapolated from the last two full steps (a "
        "linear-multistep solver on skip steps). Combine with a comma: "
        "'uncond-extrap:3,guidance-cache:2' or 'step-extrap:2'. The JAX "
        "package recommends 'step-extrap:3' for the reference workloads; "
        "PERF.md has this port's measurements")
    parser.add_argument("--compile-cache", type=str, default="", metavar="DIR",
                        help="accepted for compatibility; does nothing")
    parser.add_argument("--weights-cache", type=str, default="", metavar="DIR",
                        help="cache the assembled and merged weights in DIR: the "
                             "checkpoint assembly and LoRA merge run once per unique "
                             "checkpoint/LoRA/config set, later starts read one file")
    return parser


_APPROX_DEFAULTS = {
    "uncond-cache": 3,
    "uncond-extrap": 3,
    "guidance-cache": 2,
    "step-cache": 2,
    "step-extrap": 2,
}


def parse_approx(spec: str) -> tuple:
    """'--approx MODE[:K][,MODE[:K]]' -> (uncond_interval,
    guidance_interval, uncond_extrap, step_interval, step_extrap), as the
    JAX package's ``parse_approx``; an interval of 1 means that cache is
    off."""
    intervals = dict.fromkeys(_APPROX_DEFAULTS, 1)
    if not spec:
        return 1, 1, 0.0, 1, 0.0
    for part in spec.split(","):
        name, _, k = part.strip().partition(":")
        if name not in _APPROX_DEFAULTS:
            raise SystemExit(
                f"unknown --approx mode {name!r} (supported: "
                f"uncond-cache[:K], uncond-extrap[:K], guidance-cache[:K], "
                f"step-cache[:K], step-extrap[:K])"
            )
        interval = int(k) if k else _APPROX_DEFAULTS[name]
        if interval < 2:
            raise SystemExit(f"--approx {name}:K needs K >= 2")
        intervals[name] = interval
    if intervals["uncond-cache"] > 1 and intervals["uncond-extrap"] > 1:
        raise SystemExit(
            "--approx uncond-cache and uncond-extrap are the same cache "
            "(held vs extrapolated) — pick one"
        )
    if intervals["step-cache"] > 1 and intervals["step-extrap"] > 1:
        raise SystemExit(
            "--approx step-cache and step-extrap are the same cache "
            "(held vs extrapolated) — pick one"
        )
    extrap = 1.0 if intervals["uncond-extrap"] > 1 else 0.0
    uncond_k = max(intervals["uncond-cache"], intervals["uncond-extrap"])
    step_w = 1.0 if intervals["step-extrap"] > 1 else 0.0
    step_k = max(intervals["step-cache"], intervals["step-extrap"])
    return uncond_k, intervals["guidance-cache"], extrap, step_k, step_w


def _check_flags(args, sweep: bool = False) -> None:
    """Refuse the flags the port does not have, parse ``--approx`` into
    ``args.approx_knobs``, and check the layout flags against torchrun's
    world and the backend against the device (pointing ``args.device`` at
    the rank's card), before any file is read.  ``sweep``: the world may
    hold several data groups, and ``--cfg-pair`` needs no
    ``--frame-shard``."""
    for flag, (default, why) in UNPORTED.items():
        if getattr(args, flag) != default:
            raise SystemExit(f"--{flag.replace('_', '-')} is not available in the PyTorch "
                             f"port: {why}")
    args.approx_knobs = parse_approx(args.approx)
    try:
        args.frame_shard, args.cfg_pair = check_layout_flags(args.frame_shard, args.cfg_pair,
                                                             args.L, sweep)
    except ValueError as e:
        raise SystemExit(str(e))
    if not (args.frame_shard or args.cfg_pair):
        return
    per = max(args.frame_shard, 1) * (2 if args.cfg_pair else 1)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world % per if sweep else world != per:
        raise SystemExit(
            f"--frame-shard {args.frame_shard}{' --cfg-pair' if args.cfg_pair else ''} runs "
            f"{per} ranks per video, one process each: run under torchrun --nproc-per-node "
            f"{per}{' (or a multiple: the data groups)' if sweep else ''}; this world has "
            f"{world}")
    if sweep and args.num_processes:
        raise SystemExit("--num-processes does not compose with --frame-shard / --cfg-pair: "
                         "run the layout under torchrun")
    device = torch.device(args.device)
    if args.dist_backend == "nccl" and device.type != "cuda":
        raise SystemExit(f"--dist-backend nccl runs on CUDA devices; with --device "
                         f"{args.device} pass --dist-backend gloo")
    if args.dist_backend == "nccl" and device.index is not None and world > 1:
        raise SystemExit(f"--device {args.device} puts every rank on one card, which nccl "
                         f"refuses; pass --dist-backend gloo, or --device cuda for one card "
                         f"per rank")
    if device.type == "cuda" and device.index is None:
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"


def _load_config(args) -> InferenceConfig:
    return load_inference_config(args.inference_config, width=args.W, height=args.H,
                                 video_length=args.L)


def _setup(args, cfg: Optional[InferenceConfig] = None, layout=None) -> MotionCloneRuntime:
    if args.visible_gpu:
        print("--visible_gpu does nothing here; select the card with "
              "CUDA_VISIBLE_DEVICES or --device cuda:N")
    if args.compile_cache:
        print("--compile-cache does nothing here: the port compiles its CUDA kernels "
              "once per process")
    if args.without_xformers:
        args.attention_impl = "xla"
    if args.attention_impl in ("xla", "chunked"):
        print(f"--attention-impl {args.attention_impl}: running the port's unfused "
              f"path (flash)")
        args.attention_impl = "flash"
    uncond_k, guidance_k, uncond_w, step_k, step_w = args.approx_knobs
    if cfg is None:
        cfg = _load_config(args)
    os.makedirs(args.generated_videos_save_dir, exist_ok=True)
    with open(os.path.join(args.generated_videos_save_dir, "inference_config.json"), "w") as f:
        json.dump({k: str(v) for k, v in vars(cfg).items()}, f, indent=2)
    runtime = MotionCloneRuntime(
        args.pretrained_model_path, cfg, device=args.device,
        dtype=torch.float32 if args.float32 else torch.bfloat16,
        attention_impl=args.attention_impl, config_root=args.config_root,
        uncond_interval=uncond_k, guidance_interval=guidance_k, uncond_extrap=uncond_w,
        step_interval=step_k, step_extrap=step_w, weights_cache=args.weights_cache,
        frame_shard=args.frame_shard, cfg_pair=args.cfg_pair, dist_backend=args.dist_backend,
        layout=layout,
    )
    if args.weights_cache:
        written = (f" (entry written in {runtime.cache_write_seconds:.1f}s)"
                   if runtime.weights_cache_state == "miss" else "")
        print(f"weights cache {args.weights_cache}: {runtime.weights_cache_state}{written}; "
              f"weights loaded in {runtime.load_seconds:.1f}s")
    return runtime


def run_serial(args, cfg: Optional[InferenceConfig] = None, examples=None):
    """Every example of ``args.examples`` (or ``examples``) in turn; returns
    the runtime and the mp4 paths."""
    runtime = _setup(args, cfg)
    paths = []
    for example in load_examples(args.examples) if examples is None else examples:
        out_path = runtime.run_example(
            example,
            motion_rep_dir=args.motion_representation_save_dir,
            output_dir=args.generated_videos_save_dir,
            default_seed=args.default_seed,
            config_root=args.config_root,
            resume=args.resume,
        )
        if runtime.is_lead:
            print(out_path, "is done")
        paths.append(out_path)
    if runtime.layout is not None:
        runtime.layout.close()
    return runtime, paths


def t2v_main(argv: Optional[Sequence[str]] = None):
    """The t2v CLI; returns (runtime, mp4 paths)."""
    args = build_parser("configs/t2v_camera.yaml", "configs/t2v_camera.jsonl").parse_args(argv)
    _check_flags(args)
    return run_serial(args)


def i2v_main(argv: Optional[Sequence[str]] = None):
    """The i2v CLI (SparseCtrl conditioning; the sketch workload and seed
    76739 by default); returns (runtime, mp4 paths).  Raises before any
    weight is read when the config names no controlnet or an example's
    condition images do not pair with its ``image_index``."""
    args = build_parser("configs/i2v_sketch.yaml", "configs/i2v_sketch.jsonl",
                        default_seed=76739).parse_args(argv)
    _check_flags(args)
    cfg = _load_config(args)
    if not cfg.controlnet_path or not cfg.controlnet_config:
        raise ValueError("i2v requires controlnet_path and controlnet_config in the YAML")
    examples = load_examples(args.examples)
    for example in examples:
        if not example.condition_image_paths:
            raise ValueError(f"i2v example missing condition_image_paths: {example}")
        if len(example.image_index) != len(example.condition_image_paths):
            raise ValueError(
                f"i2v example has {len(example.condition_image_paths)} condition images "
                f"but {len(example.image_index)} image_index entries: {example}")
    return run_serial(args, cfg, examples)


def sweep_main(argv: Optional[Sequence[str]] = None):
    """The sweep CLI: every example of ``--examples`` in batches of
    ``--num-devices`` examples per sampling pass on this process's card
    (``pipeline/sweep.py``); under ``--distributed`` (torchrun), or with
    ``--num-processes N --process-id I``, this process sweeps its stride of
    the examples only, share-nothing (``parallel/distributed.py``).  Under
    torchrun with ``--frame-shard N`` and/or ``--cfg-pair`` the world splits
    into data groups of N (x 2) ranks, the JAX package's (data, [cfg,]
    frames) mesh: data group d sweeps ``partition_examples(examples, d,
    data)`` through its frame-sharded or pair-split pipeline, and no
    collective crosses data groups.  Returns (runtime, mp4 paths); a rank
    with no example returns (None, []) without loading weights."""
    from motionclone_tpu_torch.parallel.distributed import (
        maybe_initialize_from_args,
        partition_examples,
    )
    from motionclone_tpu_torch.pipeline.sweep import run_sweep

    parser = build_parser("configs/t2v_camera.yaml", "configs/t2v_camera.jsonl")
    parser.add_argument("--num-devices", type=int, default=0,
                        help="examples per sampling pass, batched on this process's card "
                             "(0: 1)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process sweep under torchrun (RANK, WORLD_SIZE, "
                             "LOCAL_RANK): each process sweeps its stride of the examples "
                             "on cuda:LOCAL_RANK, share-nothing, no collectives")
    parser.add_argument("--coordinator", type=str, default="", metavar="HOST:PORT",
                        help="implies --distributed; accepted for the JAX CLI's sake and "
                             "never contacted (no process group is needed)")
    parser.add_argument("--num-processes", type=int, default=0,
                        help="distributed process count (with --process-id)")
    parser.add_argument("--process-id", type=int, default=-1,
                        help="this process's distributed rank (with --num-processes)")
    args = parser.parse_args(argv)
    _check_flags(args, sweep=True)
    examples = load_examples(args.examples)
    layout = None
    if args.frame_shard or args.cfg_pair:
        from motionclone_tpu_torch.parallel.frames import Layout

        layout = Layout.from_env(frames=max(args.frame_shard, 1),
                                 cfg=2 if args.cfg_pair else 1, backend=args.dist_backend)
        examples = partition_examples(examples, layout.data_index, layout.data)
        if layout.is_lead:
            print(f"data group {layout.data_index}/{layout.data} (cfg {layout.cfg} x frames "
                  f"{layout.frames} ranks): {len(examples)} examples on {args.device}")
        if not examples:
            layout.close()
            return None, []
    elif maybe_initialize_from_args(args):
        examples = partition_examples(examples, args.process_id, args.num_processes)
        print(f"process {args.process_id}/{args.num_processes}: {len(examples)} examples "
              f"on {args.device}")
        if not examples:
            return None, []
    else:
        print(f"{len(examples)} examples on {args.device}")
    runtime = _setup(args, layout=layout)
    paths = run_sweep(
        runtime, examples,
        motion_rep_dir=args.motion_representation_save_dir,
        output_dir=args.generated_videos_save_dir,
        default_seed=args.default_seed,
        config_root=args.config_root,
        num_devices=args.num_devices,
        resume=args.resume,
    )
    if runtime.is_lead:
        for p in paths:
            print(p, "is done")
    if layout is not None:
        layout.close()
    return runtime, paths


def serve_main(argv: Optional[Sequence[str]] = None, ready=None) -> None:
    """The warm-runtime HTTP job server (``serve.py``) on one card: the
    weights load once, then jobs POSTed to ``/generate`` run one at a
    time, or with ``--batch-max B`` up to B queued jobs at once through
    the sweep (grouped by condition-image count; a lone job takes
    ``run_example``).  ``ready(server)``, when given, is called once the
    server listens; ``server.shutdown()`` from another thread then ends
    the call.  Under torchrun with ``--frame-shard`` (and ``--cfg-pair``)
    rank 0 serves HTTP, one job at a time (``--batch-max`` 1, the JAX
    package's rule), and sends each job to the other ranks, which run it
    in lockstep (``serve.LockstepJobs``) until the server stops."""
    from motionclone_tpu_torch.config import Example
    from motionclone_tpu_torch.pipeline.sweep import run_sweep
    from motionclone_tpu_torch.serve import MotionCloneServer

    parser = build_parser("configs/t2v_camera.yaml", "configs/t2v_camera.jsonl")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-queue", type=int, default=64,
                        help="maximum queued jobs before POST /generate returns 503")
    parser.add_argument("--batch-max", type=int, default=0,
                        help="throughput batching: drain up to this many queued jobs per "
                             "pass and sample them as one batch (pipeline/sweep.py). "
                             "0 = 1, the one card of this process: strictly serial")
    parser.add_argument("--job-timeout", type=float, default=1800.0,
                        help="per-job wall-clock bound in seconds: a job (or batch) "
                             "exceeding it is failed and the queue keeps draining; its "
                             "thread keeps the card until its call returns. 0 disables")
    args = parser.parse_args(argv)
    _check_flags(args)
    runtime = _setup(args)
    batch_max = max(args.batch_max, 1)
    if args.frame_shard and batch_max > 1:
        # a frame-sharded runtime serves one job at a time (the JAX
        # package's rule: its sweep would mix two layouts)
        print("--frame-shard set: forcing --batch-max 1 (frame-sharded runtimes serve "
              "jobs serially; use an unsharded runtime for throughput batching)")
        batch_max = 1
    where = dict(motion_rep_dir=args.motion_representation_save_dir,
                 output_dir=args.generated_videos_save_dir, default_seed=args.default_seed,
                 config_root=args.config_root, resume=args.resume)

    def run_job(example_dict):
        return runtime.run_example(Example.from_json(example_dict), **where)

    lockstep = None
    if runtime.layout is not None:
        from motionclone_tpu_torch.serve import LockstepJobs

        lockstep = LockstepJobs(runtime.layout.video)
        if not runtime.layout.is_lead:
            lockstep.follow(run_job)
            runtime.layout.close()
            return
        run_job = lockstep.leading(run_job)

    run_jobs_batch = None
    if batch_max > 1:
        def run_jobs_batch(example_dicts):
            examples = [Example.from_json(d) for d in example_dicts]
            # a sweep takes one condition-image count: group, sweep each
            # group as one batch, restore the order
            groups = {}
            for i, ex in enumerate(examples):
                groups.setdefault(len(ex.condition_image_paths), []).append(i)
            paths = [None] * len(examples)
            for indices in groups.values():
                group_paths = run_sweep(runtime, [examples[i] for i in indices],
                                        num_devices=len(indices), **where)
                for i, p in zip(indices, group_paths):
                    paths[i] = p
            return paths

    server = MotionCloneServer(run_job, run_jobs_batch=run_jobs_batch, batch_max=batch_max,
                               host=args.host, port=args.port, max_queue=args.max_queue,
                               job_timeout=args.job_timeout or None)
    print(f"motionclone-serve listening on http://{args.host}:{server.port} "
          "(POST /generate, GET /jobs /health /metrics)", flush=True)
    if ready is not None:
        ready(server)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    if lockstep is not None:
        lockstep.stop()
        runtime.layout.close()


if __name__ == "__main__":
    t2v_main()
