"""Time the frame group's collectives over gloo between processes on this host.

    python3 scripts/torch_gloo_gather.py [--ranks 2 4] [--device cuda:0|cpu]

For each group size, ``parallel.frames.launch`` spawns that many gloo ranks
and each times, at the largest keys/values a frame-sharded UNet gathers
(1 x 16 frames x 4096 pixels x 320 channels, bf16, the rank's 16/N
frames): ``FrameGroup.gather_frames`` (gloo's ``all_gather`` through host
memory), the same gather as one ``broadcast`` from each rank, and
``FrameGroup.all_reduce_sum`` of the whole cotangent (in f32), which the
gather's backward runs.  Prints one JSON line per group size,
milliseconds per call (the median of 8 after 2 warm-up calls, rank 0's
clock).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from motionclone_tpu_torch.parallel.frames import launch  # noqa: E402

FRAMES, PIXELS, CHANNELS = 16, 4096, 320


def _median_ms(fn, device, reps: int = 8, warmup: int = 2) -> float:
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_rank(group, device: str) -> dict:
    torch.set_num_threads(1)
    dev = torch.device(device)
    f = FRAMES // group.size
    x = torch.randn(1, f, PIXELS, CHANNELS, device=dev).to(torch.bfloat16)
    host = x.cpu()
    parts = [host if r == group.rank else torch.empty_like(host) for r in range(group.size)]

    def broadcasts():
        for r, part in enumerate(parts):
            dist.broadcast(part if r != group.rank else x.cpu(), src=r)
        torch.cat(parts, dim=1).to(dev)

    cot = torch.randn(1, FRAMES, PIXELS, CHANNELS, device=dev).to(torch.bfloat16)
    return {"ranks": group.size, "device": str(dev), "part_mb": host.numel() * 2 / 1e6,
            "all_gather_ms": _median_ms(lambda: group.gather_frames(x), dev),
            "broadcasts_ms": _median_ms(broadcasts, dev),
            "all_reduce_f32_ms": _median_ms(lambda: group.all_reduce_sum(cot), dev)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    parser.add_argument("--device", default="cuda:0",
                        help="where the tensors live: cuda:K (every rank on card K), or cpu")
    args = parser.parse_args()
    for n in args.ranks:
        devices = None if args.device == "cpu" else [args.device] * n
        rows = launch(time_rank, n, backend="gloo", devices=devices, args=(args.device,),
                      timeout=300.0)
        print(json.dumps({k: (round(v, 2) if isinstance(v, float) else v)
                          for k, v in rows[0].items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
