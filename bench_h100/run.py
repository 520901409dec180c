"""The port's benchmark: one run of one cell on the card it is started on.

    python3 bench_h100/run.py --workload t2v_camera.b2 --seed 7 --seconds 35 --trace 0

Prints progress and the checks on standard error, and as the last line of
standard output one JSON object: ``correct``, ``attempted`` and ``failed``
(videos), ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number with its limit).
Exits non-zero, printing no result, without a CUDA card, with fewer cards
than the cell asks for, or if ``jax``, ``jaxlib``, ``flax`` or the JAX
package were loaded.  Build and kernel caches stay under ``build/`` in the
checkout.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "motionclone_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX one or the JAX
    package's (compared whole: ``motionclone_tpu_torch`` is not)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result_line(out, device, trace: bool):
    """The last line's object: the result's keys, then ``checks`` last."""
    device = dict(device, memory_peak_bytes=out["peak_bytes"])
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": device}
    if trace:
        device["busy_s"], device["window_s"] = out["busy_s"], out["traced_window_s"]
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the checkout's fixed cache directories (the kernel library is built
    # under build/ by the program itself)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    sys.path.insert(0, ROOT)
    import torch

    before = [("torch_import", time.perf_counter())]
    from bench_h100 import harness

    cell = harness.load_cell(args.workload)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        chips = {w["name"]: w["chips"] for w in json.load(fh)["workloads"]}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        print(f"bench_h100: needs {chips[args.workload]} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.cuda.init()
    before.append(("card", time.perf_counter()))
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", STARTED,
                      before=before)

    found = forbidden_modules()
    if found:
        print(f"bench_h100: the run loaded {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips[args.workload], "power_limit_w": power_limit_w()}
    result = result_line(out, device, bool(args.trace))
    print(f"bench_h100: {args.workload} seed {args.seed}: window {out['window_s']:.3f} s, "
          f"{out['attempted']} videos, set-up {out['setup_s']:.3f} s, reference "
          f"{out['reference_s']:.3f} s, checked job {out['checked_job']} steps {out['steps']}, "
          f"{time.perf_counter() - STARTED:.3f} s in all", file=sys.stderr)
    print(f"bench_h100: diagnostics {json.dumps(out['diagnostics'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
